"""The plain PyTorch version's CBOC and gain branches against the Pallas
kernel `_kernel_v5` itself (cboc=True, use_gain=True), run in Pallas
interpret mode on the CPU as the JAX package's own tests run it, in both
the emit="i32pack" and the emit="int16" layouts.  CBOC outputs are held
to `cboc_bar` (>= 99.8% of int16 values identical, every difference
within 1000), sine-BOC with gain to the engine bar (>= 99.9%).  n_k = 8
keeps the interpreter quick: one trace per operand structure and emit,
then milliseconds a call."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.ops.synth_kp_pallas import synth_accum_kp_pallas
from galileo_sdr_sim_tpu_torch.harness import CASES, cboc_bar, engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp

from _torch_parity import CPU, fixture_batch, synthetic_pair

N_K = 8
VARIANTS = {"cboc": dict(cboc=True), "gain": dict(gain=True), "cboc_gain": dict(cboc=True, gain=True)}
EMITS = ("i32pack", "int16")
_PALLAS = {
    emit: jax.jit(functools.partial(synth_accum_kp_pallas, n_k=N_K, interpret=True, emit=emit))
    for emit in EMITS
}
_PLAIN = {"i32pack": tkp.synth_kp_packed_ref, "int16": tkp.synth_kp_int16_ref}


def _bar(variant):
    return cboc_bar if "cboc" in variant else engine_bar


@pytest.mark.parametrize("emit", EMITS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_pallas_interpret_synthetic(variant, case, emit):
    j, t = synthetic_pair(2, 8, seed=42, case=case, **VARIANTS[variant])
    j = {k: v for k, v in j.items() if k != "vpack"}
    ref = np.asarray(_PALLAS[emit](j))
    got = _PLAIN[emit](t, N_K).numpy()
    assert got.shape == ref.shape
    bar = _bar(variant)(got, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("emit", EMITS)
@pytest.mark.parametrize("variant", ["cboc", "cboc_gain"])
def test_plain_matches_pallas_interpret_cboc_fixture(variant, emit):
    """The first two epochs of the CBOC fixture scene, as prepared by the
    JAX package (gain from the scene under cboc_gain)."""
    batch = fixture_batch(model=E1_CBOC)
    first2 = dataclasses.replace(
        batch,
        **{f: getattr(batch, f)[:2] for f in (
            "grx_sec", "f_carr", "f_code", "code_phase0", "carr_phase0",
            "sym_win", "pilot_win", "gain")},
    )
    gain = variant == "cboc_gain"
    j = jkp.prepare_kp_inputs(first2, N_K * 1300, pack_g=True, apply_gain=gain)
    t = tkp.prepare_kp_inputs(first2, N_K * 1300, device=CPU, apply_gain=gain)
    ref = np.asarray(_PALLAS[emit]({k: v for k, v in j.items() if k != "vpack"}))
    got = _PLAIN[emit](t, N_K).numpy()
    bar = cboc_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size
