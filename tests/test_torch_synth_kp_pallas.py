"""The plain PyTorch version of the kernel against the Pallas kernel
`_kernel_v5` itself, run in Pallas interpret mode on the CPU as the JAX
package's own tests run it (emit="i32pack", sine-BOC, no gain).  Held to
the engine bar (>= 99.9% of int16 values identical, every difference
within 4 * LUT_AMPLITUDE = 1000).  Shapes are small: the interpreter
executes the kernel op by op (~7 s per B=2, n_k=16 call).

Seed 42 is one where the reference's own two engines agree: at seeds 40
and 41 of the 'negated_mu' case the JAX XLA engine and the Pallas
interpreter differ from EACH OTHER by up to 1464 at a few samples on the
CPU (XLA vs interpreter, no port code involved), while the port stays
within the bar of the XLA engine there (tests/test_torch_synth_kp.py)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.ops.synth_kp_pallas import synth_accum_kp_pallas
from galileo_sdr_sim_tpu_torch.convert import kp_inputs_from_jax
from galileo_sdr_sim_tpu_torch.harness import CASES, engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp

from _torch_parity import CPU, fixture_batch, synthetic_pair

N_K = 16  # the fixture scene's first epochs

# one trace of the interpreted kernel per n_k, shared by the cases
_PALLAS = {
    n_k: jax.jit(functools.partial(
        synth_accum_kp_pallas, n_k=n_k, interpret=True, emit="i32pack"))
    for n_k in (8, 16)
}


@pytest.mark.parametrize("n_k", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret_synthetic(case, n_k):
    j, t = synthetic_pair(2, 8, seed=42, case=case)
    ref = np.asarray(_PALLAS[n_k](j))
    got = tkp.synth_kp_packed_ref(t, n_k).numpy()
    assert got.shape == ref.shape == (2, n_k, 1300)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


def test_plain_matches_pallas_interpret_fixture_scene():
    batch = fixture_batch()
    first2 = dataclasses.replace(
        batch,
        **{f: getattr(batch, f)[:2] for f in (
            "grx_sec", "f_carr", "f_code", "code_phase0", "carr_phase0",
            "sym_win", "pilot_win", "gain")},
    )
    j = jkp.prepare_kp_inputs(first2, N_K * 1300, pack_g=True)
    t = kp_inputs_from_jax({k: np.asarray(v) for k, v in j.items()}, CPU)
    ref = np.asarray(_PALLAS[N_K](j))
    got = tkp.synth_kp_packed_ref(t, N_K).numpy()
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size
