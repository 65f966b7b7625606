"""The port's kp entry points against the Pallas kernel `_kernel_v5` in
its K-vectorised v6 main loop (`vec_kt=True`), the main loop of the
port's CUDA kernel, run in Pallas interpret mode on the CPU as the JAX
package's own tests run it.

On the CPU the entry points run their plain versions (the v6 schedule
changes no value: every element sees the per-row op sequence and channel
order); on the card tests/test_torch_cuda.py holds the kernel to them.
Held to the engine bar (>= 99.9% of int16 values identical, every
difference within 1000; `cboc_bar`, 99.8%, for CBOC).  Seed 42, as
in tests/test_torch_synth_kp_pallas.py: one jitted trace per operand
structure, emit and n_k, shared by the cases, and eight interpreter calls
in all."""

import functools

import jax
import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.ops.synth_kp_pallas import synth_accum_kp_pallas
from galileo_sdr_sim_tpu_torch.harness import cboc_bar, engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

from _torch_parity import synthetic_pair


@functools.lru_cache(maxsize=None)
def _pallas(n_k: int, emit: str):
    return jax.jit(functools.partial(
        synth_accum_kp_pallas, n_k=n_k, interpret=True, emit=emit, vec_kt=True))


def _jax_inputs(j: dict) -> dict:
    return {k: v for k, v in j.items() if k != "vpack"}


@pytest.mark.parametrize("case, n_k", [
    ("random", 8), ("half_chip", 16), ("carrier_wrap", 8), ("negated_mu", 16), ("edges", 8),
])
def test_packed_vec_kt_matches_pallas_v6(case, n_k):
    j, t = synthetic_pair(2, 8, seed=42, case=case)
    ref = np.asarray(_pallas(n_k, "i32pack")(_jax_inputs(j)))
    got = synth_kp_cuda.synth_kp_packed(t, n_k)
    assert got.shape == ref.shape == (2, n_k, 1300)
    bar = engine_bar(got.numpy(), ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("case, n_k", [("random", 8), ("edges", 16)])
def test_int16_vec_kt_cboc_gain_matches_pallas_v6(case, n_k):
    j, t = synthetic_pair(2, 8, seed=42, case=case, cboc=True, gain=True)
    assert synth_kp_cuda.instantiation(t) == "synth_kp_v5_cboc_gain"
    ref = np.asarray(_pallas(n_k, "int16")(_jax_inputs(j)))
    got = synth_kp_cuda.synth_kp_int16(t, n_k)
    assert got.shape == ref.shape == (2, 2 * n_k * 1300)
    bar = cboc_bar(got.numpy(), ref)
    assert bar["ok"], bar


def test_accum_vec_kt_matches_pallas_v6_truncated():
    j, t = synthetic_pair(2, 8, seed=42, case="random")
    assert synth_kp_cuda.instantiation(t, f32=True) == "synth_kp_v5_f32"
    ref = np.array(_pallas(8, "f32")(_jax_inputs(j)))
    got = synth_kp_cuda.synth_kp_accum(t, 8)
    assert got.shape == ref.shape == (2, 8 * 1300, 2)
    assert np.isfinite(ref).all() and bool(got.isfinite().all())
    bar = engine_bar(tkp.pack_iq(got).numpy(), tkp.pack_iq(torch.from_numpy(ref)).numpy())
    assert bar["ok"], bar


def test_cpu_path_counts_no_launch():
    """The six instantiations and the prologue kernel are counted where
    they launch, and nowhere else: the CPU path of each entry point
    counts nothing."""
    assert len(synth_kp_cuda.REPLACES) == 7 and synth_kp_cuda.PLANES in synth_kp_cuda.REPLACES
    _, t = synthetic_pair(1, 2, seed=42, case="random")
    _, g = synthetic_pair(1, 2, seed=42, case="random", cboc=True, gain=True)
    before = (synth_kp_cuda.launch_count, dict(synth_kp_cuda.launch_counts),
              synth_kp_cuda.int16_launch_count)
    synth_kp_cuda.synth_kp_packed(t, 8)
    synth_kp_cuda.synth_kp_accum(t, 8)
    synth_kp_cuda.synth_kp_int16(g, 8)
    synth_kp_cuda.kp_planes(t, 8)
    assert (synth_kp_cuda.launch_count, synth_kp_cuda.launch_counts,
            synth_kp_cuda.int16_launch_count) == before

