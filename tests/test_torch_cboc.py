"""CBOC(6,1,1/11) and per-channel gain through the port's factorized
engine, against the JAX package.

Host prep must equal the JAX `prepare_kp_inputs` exactly (`cboc_ab`,
`chan_gain`, the +-1 banks through their window table `vpack_rs`), and
a 12-grid table that does not factor must raise as in the JAX package.
The plain PyTorch version is held to the JAX XLA engine: CBOC outputs
to `cboc_bar` (>= 99.8% of int16 values identical, every difference
within 1000: CBOC has 12 transitions a chip against sine-BOC's 2),
sine-BOC with gain to the engine bar (>= 99.9%, within 1000).  The
Pallas interpreter is tests/test_torch_cboc_pallas.py; the CUDA kernel
is tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.models.cboc import ALPHA, BETA, E1_CBOC
from galileo_sdr_sim_tpu.models.e1 import E1_OS
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu_torch.convert import kp_inputs_from_jax
from galileo_sdr_sim_tpu_torch.harness import CASES, cboc_bar, engine_bar, synthetic_operands
from galileo_sdr_sim_tpu_torch.models import cboc as tcboc
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

from _torch_parity import CPU, fixture_batch, synthetic_pair

VARIANTS = {"cboc": dict(cboc=True), "gain": dict(gain=True), "cboc_gain": dict(cboc=True, gain=True)}


@pytest.fixture(scope="module")
def cboc_batch():
    return fixture_batch(model=E1_CBOC)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _bar(variant):
    return cboc_bar if "cboc" in variant else engine_bar


# --- host prep: exact ---------------------------------------------------


@pytest.mark.parametrize("apply_gain", [False, True])
def test_cboc_prep_matches_jax_exactly(cboc_batch, apply_gain):
    j = jkp.prepare_kp_inputs(cboc_batch, 16 * 1300, pad_epochs=8, pack_g=True, apply_gain=apply_gain)
    t = tkp.prepare_kp_inputs(cboc_batch, 16 * 1300, pad_epochs=8, device=CPU, apply_gain=apply_gain)
    np.testing.assert_array_equal(t["cboc_ab"].numpy(), np.asarray(j["cboc_ab"]))
    assert t["cboc_ab"].dtype == torch.float32 and t["cboc_ab"].device.type == "cpu"
    np.testing.assert_array_equal(t["vpack_rs"].numpy(), np.asarray(j["vpack_rs"]))
    assert ("chan_gain" in t) is apply_gain is ("chan_gain" in j)
    if apply_gain:
        np.testing.assert_array_equal(t["chan_gain"].numpy(), np.asarray(j["chan_gain"]))
    via = kp_inputs_from_jax(_np(j), CPU)
    assert set(t) == set(via)
    for k in t:
        assert t[k].dtype == via[k].dtype and torch.equal(t[k], via[k]), k


def test_gain_prep_matches_jax_exactly():
    batch = fixture_batch()
    j = jkp.prepare_kp_inputs(batch, 10400, pad_epochs=8, pack_g=True, apply_gain=True)
    t = tkp.prepare_kp_inputs(batch, 10400, pad_epochs=8, device=CPU, apply_gain=True)
    assert "cboc_ab" not in t
    np.testing.assert_array_equal(t["chan_gain"].numpy(), np.asarray(j["chan_gain"]))
    # the peak is taken per block: one channel of one epoch sits at 1;
    # the idle eighth slot weighs 0
    g = t["chan_gain"]
    assert g.max().item() == 1.0
    active = torch.from_numpy(tkp.compact_channels(batch).prn > 0)
    assert (g[:, active] > 0).all() and (g[:, ~active] == 0).all()


@pytest.mark.parametrize("component, anti", [("data_codes", False), ("pilot_codes", True)])
def test_port_cboc_tables_are_built_once_and_read_only(component, anti):
    """The port's CBOC tables are built once a process: every read, of
    every model instance, is the one array, which refuses a write, and
    holds the values a fresh build and the JAX package's table hold."""
    table = getattr(tcboc.E1_CBOC, component)
    assert table is getattr(tcboc.E1_CBOC, component)
    assert table is getattr(tcboc.E1CbocSignalModel(), component)
    assert not table.flags.writeable
    with pytest.raises(ValueError):
        table[0, 0] = 0.0
    fresh = tcboc._cboc_table.__wrapped__("E1C" if anti else "E1B", anti=anti)
    assert fresh is not table and table.dtype == fresh.dtype == np.float32
    np.testing.assert_array_equal(table, fresh)
    np.testing.assert_array_equal(table, getattr(E1_CBOC, component))


def test_cboc_weights_and_banks():
    """(alpha, beta) derived from the model's tables are the float32
    rounding of sqrt(10/11), sqrt(1/11) to the last bit or one ulp, and
    the +-1 banks of the CBOC tables are the sine-BOC half-chip banks
    (both use the reference's 'starts negative' convention)."""
    tab_b, tab_c = E1_CBOC.data_codes[:6], E1_CBOC.pilot_codes[:6]
    ab = tkp.cboc_weights(tab_b)
    assert ab.dtype == np.float32 and ab.shape == (2,)
    np.testing.assert_allclose(ab, np.float32([ALPHA, BETA]), rtol=2 ** -23)
    sign_b, sign_c = tkp.cboc_sign_banks(tab_b, tab_c, ab)
    assert sign_b.dtype == np.int8 and sign_b.shape == (6, 8184)
    np.testing.assert_array_equal(sign_b, E1_OS.data_codes[:6])
    np.testing.assert_array_equal(sign_c, E1_OS.pilot_codes[:6])
    np.testing.assert_array_equal(
        tkp._pack_codes_rs(sign_b, sign_c),
        jkp._pack_codes_rs(np.sign(tab_b[:, ::6]).astype(np.int8), np.sign(tab_c[:, ::6]).astype(np.int8)),
    )


def _corrupt(batch):
    bad_b = batch.codes_b.copy()
    act = np.nonzero(np.any(bad_b, axis=1))[0][0]
    bad_b[act, 7] *= 3.0  # one sub-position weight off: still 12-grid wide
    return dataclasses.replace(batch, codes_b=bad_b)


def test_non_factorable_12grid_table_raises(cboc_batch):
    """As tests/test_cboc.py::test_kp_rejects_non_factorable_12grid_table:
    a 12-subdiv table that does not decompose as halfchip*(alpha +/-
    beta*tau) raises in both packages instead of synthesizing wrong."""
    bad = _corrupt(cboc_batch)
    with pytest.raises(ValueError, match="does not factor"):
        jkp.prepare_kp_inputs(bad, 10400)
    with pytest.raises(ValueError, match="does not factor"):
        tkp.prepare_kp_inputs(bad, 10400, device=CPU)


def test_factorization_guard_runs_only_when_the_table_is_built(cboc_batch):
    """The guard runs when the code table is (re)built, as in the JAX
    package: a cached table under the same (PRNs, width) key skips it."""
    bad = _corrupt(cboc_batch)
    j_cache, t_cache = {}, {}
    jkp.prepare_kp_inputs(cboc_batch, 10400, code_cache=j_cache)
    tkp.prepare_kp_inputs(cboc_batch, 10400, code_cache=t_cache, device=CPU)
    jkp.prepare_kp_inputs(bad, 10400, code_cache=j_cache)
    tkp.prepare_kp_inputs(bad, 10400, code_cache=t_cache, device=CPU)
    prn = tkp.compact_channels(cboc_batch).prn
    assert t_cache["key"] == (prn.tobytes(), tkp.CBOC_WIDTH)


def test_other_table_widths_are_refused(cboc_batch):
    odd = dataclasses.replace(
        cboc_batch, codes_b=cboc_batch.codes_b[:, :24552], codes_c=cboc_batch.codes_c[:, :24552]
    )
    with pytest.raises(ValueError, match="table width 24552"):
        tkp.prepare_kp_inputs(odd, 10400, device=CPU)


# --- plain version vs the JAX XLA engine ----------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_xla_synthetic(variant, case):
    j, t = synthetic_pair(2, 8, seed=30, case=case, **VARIANTS[variant])
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=8, engine="xla"))
    got = tkp.synth_kp_packed_ref(t, 8).numpy()
    assert got.shape == ref.shape == (2, 8, 1300)
    bar = _bar(variant)(got, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_int16_matches_xla_int16(variant):
    """emit="int16": the packed output viewed as int16 against the XLA
    engine's flat int16 block (synth_block_kp)."""
    j, t = synthetic_pair(2, 16, seed=31, case="random", **VARIANTS[variant])
    ref = np.asarray(jkp.synth_block_kp(j, n_k=16, engine="xla"))
    got = tkp.synth_kp_int16_ref(t, 16)
    assert got.dtype == torch.int16 and tuple(got.shape) == ref.shape == (2, 2 * 16 * 1300)
    np.testing.assert_array_equal(got.numpy(), tkp.packed_to_iq16(tkp.synth_kp_packed_ref(t, 16).numpy()))
    bar = _bar(variant)(got, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_xla_fixture_block(variant, cboc_batch):
    """The CBOC fixture scene (sine-BOC scene for gain alone), B = 8
    epochs of 16 rows, with per-channel gain from the scene."""
    batch = cboc_batch if "cboc" in variant else fixture_batch()
    gain = "gain" in variant
    j = jkp.prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, pack_g=True, apply_gain=gain)
    t = tkp.prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, device=CPU, apply_gain=gain)
    ref = np.asarray(jkp.synth_block_kp_packed(j, n_k=16, engine="xla"))
    got = tkp.synth_kp_packed_ref(t, 16).numpy()
    bar = _bar(variant)(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size


def test_cboc_differs_from_sine_boc():
    """The CBOC branch is taken: the same operands with and without the
    weights give different samples, and alpha = 1, beta = 0 gives the
    sine-BOC output exactly."""
    _, t = synthetic_pair(2, 8, seed=32, case="random", cboc=True)
    cboc = tkp.synth_kp_packed_ref(t, 8)
    sine = tkp.synth_kp_packed_ref({k: v for k, v in t.items() if k != "cboc_ab"}, 8)
    assert (cboc != sine).float().mean() > 0.5
    unit = dict(t, cboc_ab=torch.tensor([1.0, 0.0]))
    assert torch.equal(tkp.synth_kp_packed_ref(unit, 8), sine)


def test_unit_gain_is_the_identity():
    _, t = synthetic_pair(2, 8, seed=33, case="edges", gain=True)
    plain = {k: v for k, v in t.items() if k != "chan_gain"}
    unit = dict(plain, chan_gain=torch.ones_like(t["chan_gain"]))
    assert torch.equal(tkp.synth_kp_packed_ref(unit, 8), tkp.synth_kp_packed_ref(plain, 8))


# --- the wrapper ----------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_wrapper_picks_the_instantiation_and_checks_operands(variant):
    _, t = synthetic_pair(2, 8, seed=34, case="random", **VARIANTS[variant])
    assert synth_kp_cuda.instantiation(t) == f"synth_kp_v5_{variant}"
    assert synth_kp_cuda._check(t, 8) == (2, 8)
    before = dict(synth_kp_cuda.launch_counts)
    out = synth_kp_cuda.synth_kp_int16(t, 8)  # CPU tensors: the plain version
    assert synth_kp_cuda.launch_counts == before
    assert out.dtype == torch.int16 and tuple(out.shape) == (2, 2 * 8 * 1300)
    if "cboc" in variant:
        with pytest.raises(ValueError, match="cboc_ab"):
            synth_kp_cuda._check(dict(t, cboc_ab=t["cboc_ab"].double()), 8)
        with pytest.raises(ValueError, match="cboc_ab"):
            synth_kp_cuda._check(dict(t, cboc_ab=t["cboc_ab"][:1]), 8)
    if "gain" in variant:
        with pytest.raises(ValueError, match="chan_gain"):
            synth_kp_cuda._check(dict(t, chan_gain=t["chan_gain"][:1]), 8)


def test_reset_counts():
    synth_kp_cuda.launch_counts["synth_kp_v5_cboc"] += 3
    synth_kp_cuda.reset_counts()
    assert synth_kp_cuda.launch_count == synth_kp_cuda.int16_launch_count == 0
    assert set(synth_kp_cuda.launch_counts.values()) == {0}
    assert set(synth_kp_cuda.launch_counts) == set(synth_kp_cuda.REPLACES)


def test_synthetic_variants_keep_the_base_draws():
    base, b0, c0 = synthetic_operands(3, 8, 5, "edges")
    full, b1, c1 = synthetic_operands(3, 8, 5, "edges", cboc=True, gain=True)
    for k in base:
        np.testing.assert_array_equal(full[k], base[k], err_msg=k)
    np.testing.assert_array_equal(b1, b0)
    np.testing.assert_array_equal(c1, c0)
    g = full["chan_gain"]
    assert g.dtype == np.float32 and g.shape == (3, 8) and (g > 0).all() and (g <= 1).all()
