"""PyTorch port of the factorized (K, p) engine against the JAX package:
host prep operand by operand (exact), and the plain PyTorch version of the
kernel against the JAX XLA engine (engine bar: >= 99.9% of int16 values
identical, every difference within 4 * LUT_AMPLITUDE = 1000, the
chip-transition timing-ULP class of tests/test_synth_kp_pallas.py).  The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.ops import synth as jsynth
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.ops.synth_kp_pallas import _pack_pm1_bits, _window_anchors
from galileo_sdr_sim_tpu_torch.convert import batch_to_device, kp_inputs_from_jax
from galileo_sdr_sim_tpu_torch.harness import CASES, engine_bar, synthetic_operands
from galileo_sdr_sim_tpu_torch.ops import synth as tsynth
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

from _torch_parity import CPU, fixture_batch, synthetic_pair


@pytest.fixture(scope="module")
def batch():
    return fixture_batch()


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


# --- host prep: exact ---------------------------------------------------


def test_prepare_kp_inputs_matches_jax_exactly(batch):
    j = jkp.prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, pack_g=True)
    t = tkp.prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, device=CPU)
    via = kp_inputs_from_jax(_np(j), CPU)
    assert set(t) == set(via) == set(tkp.SCALAR_OPERANDS) | {"vpack_rs"}
    for k in t:
        assert t[k].dtype == via[k].dtype, k
        assert torch.equal(t[k], via[k]), k
    for k in ("cp0", "two_a", "mu", "carr0", "fc", "fc_k"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    np.testing.assert_array_equal(t["vpack_rs"].numpy(), np.asarray(j["vpack_rs"]))
    g0, o, r = _window_anchors(j)
    np.testing.assert_array_equal(t["g0"].numpy(), np.asarray(g0, np.float32))
    np.testing.assert_array_equal(t["o"].numpy(), np.asarray(o))
    np.testing.assert_array_equal(t["r"].numpy(), np.asarray(r).astype(np.float32))
    np.testing.assert_array_equal(t["sym_bits"].numpy(), np.asarray(_pack_pm1_bits(j["sym_win"])))
    np.testing.assert_array_equal(t["pil_bits"].numpy(), np.asarray(_pack_pm1_bits(j["pilot_win"])))


@pytest.mark.parametrize("case", CASES)
def test_window_anchors_and_bits_match_jax(case):
    host, _, _ = synthetic_operands(5, 16, seed=3, case=case)
    j = {k: np.asarray(v) for k, v in host.items()}
    g0, o, r = _window_anchors(j)
    tg0, to, tr = tkp._window_anchors(host["cp0"], host["mu"])
    np.testing.assert_array_equal(tg0, np.asarray(g0))
    np.testing.assert_array_equal(to, np.asarray(o))
    np.testing.assert_array_equal(tr, np.asarray(r))
    for w in ("sym_win", "pilot_win"):
        np.testing.assert_array_equal(tkp._pack_pm1_bits(host[w]), np.asarray(_pack_pm1_bits(host[w])))


def test_pack_codes_rs_matches_jax():
    _, codes_b, codes_c = synthetic_operands(1, 4, seed=0)
    np.testing.assert_array_equal(
        tkp._pack_codes_rs(codes_b, codes_c), jkp._pack_codes_rs(codes_b, codes_c)
    )


def test_host_helpers_match_jax(batch):
    jb, tb = jkp.compact_channels(batch), tkp.compact_channels(batch)
    for f in ("prn", "f_carr", "code_phase0", "sym_win", "codes_b", "codes_c"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    padded_j, padded_t = jsynth._pad_batch(jb, 11), tsynth._pad_batch(jb, 11)
    for f in ("f_code", "carr_phase0", "pilot_win", "gain", "grx_sec"):
        np.testing.assert_array_equal(getattr(padded_t, f), getattr(padded_j, f), err_msg=f)
    assert tkp.mu_in_envelope(batch.f_code) == jkp.mu_in_envelope(batch.f_code)
    bad = batch.f_code.copy()
    bad[0, 0] += 10.0  # 0.01 half-chips of drift per row: out of envelope
    assert tkp.mu_in_envelope(bad) is jkp.mu_in_envelope(bad) is False
    packed = np.arange(-5000, 5000, dtype=np.int32).reshape(2, 1, 5000)
    np.testing.assert_array_equal(tkp.packed_to_iq16(packed), jkp.packed_to_iq16(packed))
    for name, got in batch_to_device(batch, CPU).items():
        np.testing.assert_array_equal(got.numpy(), getattr(batch, name), err_msg=name)
    assert (tkp.P_GRID, tkp.ROWS, tkp.COLS, tkp.K_EPOCH, tkp.W_PACK) == (
        jkp.P_GRID, jkp.ROWS, jkp.COLS, jkp.K_EPOCH, jkp.W_PACK)
    assert (tkp.J_RS, tkp.W_RS, tkp.T_RS, tkp.MU_MAX) == (jkp.J_RS, jkp.W_RS, jkp.T_RS, jkp.MU_MAX)


def test_amplitude_in_symbol_window_is_refused():
    host, _, _ = synthetic_operands(2, 8, seed=1)
    with pytest.raises(ValueError, match="amplitude"):
        tkp._pack_pm1_bits(host["sym_win"] * 0.5 + host["sym_win"])


def test_unported_branches_raise(batch):
    """The table geometries the factorized engine does not take are
    refused, as the JAX package refuses them: a 12-grid table whose
    entries do not factor over +-1 half-chip banks (a sine-BOC table
    repeated 6x factors, with alpha = 1 and beta = 0, until one
    sub-position is scaled) and any other width."""
    wide_b = np.repeat(batch.codes_b, 6, axis=1)
    wide_b[np.flatnonzero(batch.prn > 0)[0], 7] *= 3
    wide = dataclasses.replace(batch, codes_b=wide_b, codes_c=np.repeat(batch.codes_c, 6, axis=1))
    with pytest.raises(ValueError, match="does not factor"):
        jkp.prepare_kp_inputs(wide, 10400)
    with pytest.raises(ValueError, match="does not factor"):
        tkp.prepare_kp_inputs(wide, 10400, device=CPU)
    odd = dataclasses.replace(
        batch, codes_b=np.repeat(batch.codes_b, 3, axis=1), codes_c=np.repeat(batch.codes_c, 3, axis=1)
    )
    with pytest.raises(ValueError, match="table width"):
        tkp.prepare_kp_inputs(odd, 10400, device=CPU)
    with pytest.raises(ValueError, match="vpack_rs"):
        kp_inputs_from_jax({"cboc_ab": np.zeros(2, np.float32)}, CPU)


# --- plain version vs the JAX XLA engine ---------------------------------


@pytest.mark.parametrize("n_k", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_synthetic(case, n_k):
    j, t = synthetic_pair(2, 8, seed=20 + n_k, case=case)
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=n_k, engine="xla"))
    got = tkp.synth_kp_packed_ref(t, n_k).numpy()
    assert got.shape == ref.shape == (2, n_k, 1300)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


def test_plain_matches_xla_fixture_first_epochs(batch):
    j = jkp.prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, pack_g=True)
    t = kp_inputs_from_jax(_np(j), CPU)
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=16, engine="xla"))
    bar = engine_bar(tkp.synth_kp_packed_ref(t, 16).numpy(), ref)
    assert bar["ok"], bar


def test_plain_matches_xla_full_block(batch):
    """One production-size block: B=8 epochs of 200 rows x 1300 samples."""
    j = jkp.prepare_kp_inputs(batch, 260000, pad_epochs=8, pack_g=True)
    t = tkp.prepare_kp_inputs(batch, 260000, pad_epochs=8, device=CPU)
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=200, engine="xla"))
    got = tkp.synth_kp_packed_ref(t, 200).numpy()
    assert got.shape == (8, 200, 1300)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size


def test_plain_handles_sixteen_channels():
    j, t = synthetic_pair(2, 16, seed=5, case="random")
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=8, engine="xla"))
    bar = engine_bar(tkp.synth_kp_packed_ref(t, 8).numpy(), ref)
    assert bar["ok"], bar


# --- the wrapper ----------------------------------------------------------


def test_wrapper_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    _, t = synthetic_pair(2, 8, seed=2, case="edges")
    calls = []

    def plain(inputs, n_k):
        calls.append(n_k)
        return tkp.synth_kp_packed_ref(inputs, n_k)

    monkeypatch.setattr(synth_kp_cuda, "synth_kp_packed_ref", plain)
    before = synth_kp_cuda.launch_count
    got = synth_kp_cuda.synth_kp_packed(t, 16)
    assert calls == [16]
    assert synth_kp_cuda.launch_count == before  # no kernel launched
    assert tuple(got.shape) == (2, 16, 1300) and got.dtype == torch.int32


def test_wrapper_checks_its_operands():
    _, t = synthetic_pair(2, 8, seed=2, case="random")
    with pytest.raises(ValueError, match="n_k"):
        synth_kp_cuda._check(t, 12)
    bad = dict(t, mu=t["mu"].double())
    with pytest.raises(ValueError, match="mu"):
        synth_kp_cuda._check(bad, 16)
    bad = dict(t, vpack_rs=t["vpack_rs"][:, :, :100])
    with pytest.raises(ValueError, match="vpack_rs"):
        synth_kp_cuda._check(bad, 16)
    assert synth_kp_cuda._check(t, 200) == (2, 8)
