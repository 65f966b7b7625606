"""The port's rank mesh (galileo_sdr_sim_tpu_torch/parallel/mesh.py) and
the kernel's f32 emit against the JAX package on its 8-device CPU mesh.

Bars: the engine bar (>= 99.9% of int16 values identical, every
difference within 4 * LUT_AMPLITUDE = 1000; `cboc_bar`, >= 99.8%, for
CBOC) between the two packages' float-carrier engines; the psum bar (>=
99.9% identical, no sample off by more than 1 LSB: the all-reduce
reassociates the float32 channel sum) between a sharded and an
unsharded run of the port; exact equality for shards of operands and for
the direct engine in lut512.  The port's side runs in four gloo CPU
ranks (tests/_torch_dist_worker.py, mode "mesh"), once for the module.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.ops import synth as jsynth
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.ops.synth_kp_pallas import (
    _pack_pm1_bits, _window_anchors, synth_accum_kp_pallas,
)
from galileo_sdr_sim_tpu.parallel import mesh as jmesh
from galileo_sdr_sim_tpu.parallel.distributed import PSUM_MAX_LSB, PSUM_SAMPLE_IDENTITY_BOUND
from galileo_sdr_sim_tpu_torch.convert import kp_inputs_from_jax, kp_shard
from galileo_sdr_sim_tpu_torch.harness import CASES, cboc_bar, engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

from _torch_parity import CPU, fixture_batch, run_ranks, synthetic_pair

NS = 10400  # one (8 x 1300) row cycle an epoch
N_K = NS // 1300
TILE = 1300  # as the worker's direct-engine runs
KP_MESHES = [(2, 2), (4, 1), (1, 4)]  # (n_sat, n_time), 4 ranks
LUT_MESHES = [(2, 2), (1, 4)]

# one trace of the interpreted kernel's f32 emit, shared by the cases
_PALLAS_F32 = jax.jit(functools.partial(
    synth_accum_kp_pallas, n_k=N_K, interpret=True, emit="f32"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    run_ranks("mesh", 4, out)
    return out


@pytest.fixture(scope="module")
def batch():
    return fixture_batch()


@pytest.fixture(scope="module")
def cboc_batch():
    return fixture_batch(model=E1_CBOC)


def _rank_output(ranks, name: str) -> np.ndarray:
    """The block every rank returned: all four hold the same."""
    outs = [np.load(ranks / f"{name}_r{r}.npy") for r in range(4)]
    for r, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out, outs[0], err_msg=f"{name}: rank {r} differs from rank 0")
    return outs[0]


def _packed(acc) -> np.ndarray:
    return tkp.pack_iq(torch.from_numpy(np.array(acc))).numpy()


def _port_single(batch) -> np.ndarray:
    """The port's single-process output of the block, (B, 2*NS) int16."""
    t = tkp.prepare_kp_inputs(batch, NS, pad_epochs=8, device=CPU)
    return tkp.packed_to_iq16(tkp.synth_kp_packed_ref(t, N_K).numpy())


def _psum_bar(got, ref) -> None:
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (diff == 0).mean() >= PSUM_SAMPLE_IDENTITY_BOUND, (diff == 0).mean()
    assert diff.max() <= PSUM_MAX_LSB, diff.max()


# --- the f32 emit's plain version ----------------------------------------


@pytest.mark.parametrize("cboc", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_accum_ref_matches_xla_accum(case, cboc):
    """`synth_kp_accum_ref` against the JAX `accum_kp(engine="xla")` (the
    f32 accumulator the JAX mesh psums), on the truncated values; its
    trunc-and-pack is exactly `synth_kp_packed_ref`."""
    j, t = synthetic_pair(2, 8, seed=30, case=case, cboc=cboc)
    ref = np.asarray(jkp.accum_kp(j, n_k=N_K, engine="xla"))
    got = tkp.synth_kp_accum_ref(t, N_K)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, NS, 2)
    bar = (cboc_bar if cboc else engine_bar)(_packed(got), _packed(ref))
    assert bar["ok"], bar
    assert torch.equal(tkp.pack_iq(got), tkp.synth_kp_packed_ref(t, N_K))


@pytest.mark.parametrize("case", CASES)
def test_accum_ref_matches_pallas_f32_interpret(case):
    """Against `_kernel_v5` itself with emit="f32" under the Pallas
    interpreter (seed 42: the reference's own engines agree there)."""
    j, t = synthetic_pair(2, 8, seed=42, case=case)
    ref = np.asarray(_PALLAS_F32(j))
    got = tkp.synth_kp_accum_ref(t, N_K)
    assert tuple(got.shape) == ref.shape == (2, NS, 2)
    bar = engine_bar(_packed(got), _packed(ref))
    assert bar["ok"], bar


def test_accum_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    _, t = synthetic_pair(2, 8, seed=2, case="edges", cboc=True)
    calls = []

    def plain(inputs, n_k):
        calls.append(n_k)
        return tkp.synth_kp_accum_ref(inputs, n_k)

    monkeypatch.setattr(synth_kp_cuda, "synth_kp_accum_ref", plain)
    before = dict(synth_kp_cuda.launch_counts)
    got = synth_kp_cuda.synth_kp_accum(t, N_K)
    assert calls == [N_K] and synth_kp_cuda.launch_counts == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, NS, 2)
    assert synth_kp_cuda.instantiation(t, f32=True) == "synth_kp_v5_cboc_f32"
    assert synth_kp_cuda.REPLACES["synth_kp_v5_f32"].endswith("synth_kp_pallas.py:342")
    with pytest.raises(ValueError, match="gain"):
        synth_kp_cuda.synth_kp_accum(synthetic_pair(2, 8, seed=2, case="random", gain=True)[1], N_K)


# --- host prep and shards: exact -------------------------------------------


def test_uncompacted_prep_matches_jax(batch):
    j = jkp.prepare_kp_inputs(batch, NS, pad_epochs=8, compact=False, pack_g=True)
    t = tkp.prepare_kp_inputs(batch, NS, pad_epochs=8, compact=False, device=CPU)
    via = kp_inputs_from_jax({k: np.asarray(v) for k, v in j.items()}, CPU)
    assert t["cp0"].shape == (8, 16)
    for k in t:
        assert torch.equal(t[k], via[k]), k
    cache = {}
    packed = tkp.prepare_kp_inputs(batch, NS, code_cache=cache, device=CPU)["vpack_rs"]
    wide = tkp.prepare_kp_inputs(batch, NS, code_cache=cache, compact=False, device=CPU)["vpack_rs"]
    assert packed.shape[0] == 8 and wide.shape[0] == 16  # the cache tells the layouts apart


@pytest.mark.parametrize("cboc", [False, True])
@pytest.mark.parametrize("n_sat,n_time", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_kp_shard_matches_jax_addressable_shards(batch, cboc_batch, n_sat, n_time, cboc):
    """`convert.kp_shard` cuts the port's operands as JAX's
    `shard_kp_inputs` places them on the 8-device mesh: each device's
    shard, operand by operand (the port's derived anchors and bit words
    from the JAX shard's cp0, mu and windows)."""
    b = cboc_batch if cboc else batch
    j = jkp.prepare_kp_inputs(b, NS, pad_epochs=8, compact=False, pack_g=True)
    t = kp_inputs_from_jax({k: np.asarray(v) for k, v in j.items()}, CPU)
    mesh = jmesh.make_mesh(n_sat, n_time)
    extra = ("cboc_ab",) if cboc else ()
    order = jmesh.KP_ORDER + ("vpack_rs",) + extra
    arrays = dict(zip(order, jmesh.shard_kp_inputs(j, mesh, engine="pallas")))
    for (s, ti), device in np.ndenumerate(mesh.devices):
        shard = {
            k: np.asarray(next(sh.data for sh in a.addressable_shards if sh.device == device))
            for k, a in arrays.items()
        }
        port = {k: v.numpy() for k, v in kp_shard(t, n_sat, n_time, s, ti).items()}
        for k in ("cp0", "two_a", "mu", "carr0", "fc", "fc_k", "vpack_rs") + extra:
            np.testing.assert_array_equal(port[k], shard[k], err_msg=f"{k} at sat {s} time {ti}")
        g0, o, r = _window_anchors(shard)
        np.testing.assert_array_equal(port["g0"], np.asarray(g0))
        np.testing.assert_array_equal(port["o"], np.asarray(o))
        np.testing.assert_array_equal(port["r"], np.asarray(r).astype(np.float32))
        np.testing.assert_array_equal(port["sym_bits"], np.asarray(_pack_pm1_bits(shard["sym_win"])))
        np.testing.assert_array_equal(port["pil_bits"], np.asarray(_pack_pm1_bits(shard["pilot_win"])))


def test_kp_shard_refuses_what_does_not_split(batch):
    t = tkp.prepare_kp_inputs(batch, NS, pad_epochs=8, device=CPU)  # C = 8
    with pytest.raises(ValueError, match="do not split"):
        kp_shard(t, 3, 1, 0, 0)
    with pytest.raises(ValueError, match="outside"):
        kp_shard(t, 2, 2, 2, 0)


# --- the sharded engines in four ranks ---------------------------------------


@pytest.mark.parametrize("n_sat,n_time", KP_MESHES)
def test_kp_sharded_matches_jax_mesh(ranks, batch, n_sat, n_time):
    got = _rank_output(ranks, f"kp_{n_sat}x{n_time}")
    ref = jmesh.synth_batch_kp_sharded(
        batch, jmesh.make_mesh(n_sat, n_time), nsamples=NS, pad_epochs=8, engine="xla"
    )
    assert got.shape == ref.shape == (8, 2 * NS)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    _psum_bar(got, _port_single(batch))


def test_kp_sharded_cboc_matches_jax_mesh(ranks, cboc_batch):
    """The mesh threads the replicated CBOC weights, as JAX's does."""
    got = _rank_output(ranks, "kp_cboc_2x2")
    ref = jmesh.synth_batch_kp_sharded(
        cboc_batch, jmesh.make_mesh(2, 2), nsamples=NS, pad_epochs=8, engine="xla"
    )
    bar = cboc_bar(got, ref)
    assert bar["ok"], bar
    _psum_bar(got, _port_single(cboc_batch))


@pytest.mark.parametrize("n_sat,n_time", LUT_MESHES)
def test_lut512_sharded_is_exact(ranks, batch, n_sat, n_time):
    got = _rank_output(ranks, f"lut_{n_sat}x{n_time}")
    single = np.asarray(jsynth.synth_block(
        jsynth.prepare_device_inputs(batch, tile=TILE, nsamples=NS), tile=TILE, mode="lut512"
    ))[:, : 2 * NS]
    np.testing.assert_array_equal(got, single)
    ref = jmesh.synth_batch_sharded(
        batch, jmesh.make_mesh(n_sat, n_time), tile=TILE, mode="lut512", nsamples=NS
    )
    np.testing.assert_array_equal(got, ref)
