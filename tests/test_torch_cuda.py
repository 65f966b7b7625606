"""The CUDA kernel and the port's GPU path, on the card only.

These tests import no JAX (the GPU machine has none), so they run there
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held to its plain PyTorch version on the same operands, on
the card, to the engine bar (>= 99.9% of int16 values identical, every
difference within 4 * LUT_AMPLITUDE = 1000), its CBOC instantiations to
`cboc_bar` (>= 99.8%, within 1000); the direct engine on the card must
equal its CPU run exactly under lut512.  The band-limit filter on the
card is held to its CPU run (>= 99.9% identical, every difference
within 1), and the band-limited stream to its CPU run by the per-sample
bound of `bandlimit_bar`.  The f32 emit is held to its plain version by
the same bars on its truncated values, and its truncation must equal the
packed store bit for bit (every op before the store is shared).  Without
a GPU every test skips: a CUDA kernel has no CPU mode.  The gather
kernel must equal `torch.take_along_dim`, and its plain version where an
index lies outside the table.  Every kp instantiation must reproduce the
recorded digests of its output (tests/data/torch_kp_digests.json): the
same bits as the kernel they were recorded from.  The pair of launches
of a call (the main kernel a programmatic dependent of the prologue)
gives the same bytes on another stream and from a second thread.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu_torch.harness import (
    CASES, KP_INSTANTIATIONS, AbsSumSink, bandlimit_bar, cboc_bar, engine_bar, fixture_engine,
    kp_digests, synthetic_kp_inputs,
)
from galileo_sdr_sim_tpu_torch.io.sinks import Sink
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch.models.e1 import E1_OS
from galileo_sdr_sim_tpu_torch.ops import bandlimit as tbl
from galileo_sdr_sim_tpu_torch.ops import gather_probe
from galileo_sdr_sim_tpu_torch.ops import synth as tsynth
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

NAV = Path(__file__).resolve().parent / "data" / "obs_fixture_nav.rnx"
DIST_WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
DIGESTS = Path(__file__).resolve().parent / "data" / "torch_kp_digests.json"
CPU = torch.device("cpu")
N_K = 200  # full 0.1 s epochs

VARIANTS = {"cboc": dict(cboc=True), "gain": dict(gain=True), "cboc_gain": dict(cboc=True, gain=True)}
KP_CS = [2, 8, 16]  # channel counts: tools/probe_vec_kt.py's, few to all 16 slots

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


class _Collect(Sink):
    def __init__(self):
        self.blocks = []

    def write(self, iq16: np.ndarray) -> None:
        self.blocks.append(np.array(iq16, copy=True))

    def stream(self) -> np.ndarray:
        return np.concatenate([b.reshape(-1) for b in self.blocks])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", KP_CS)
def test_kernel_matches_plain_version(gpu, C, case):
    inputs = synthetic_kp_inputs(8, C, 7, case, gpu)
    before = synth_kp_cuda.launch_count
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
    assert synth_kp_cuda.launch_count == before + 1
    ref = tkp.synth_kp_packed_ref(inputs, N_K)
    torch.cuda.synchronize()
    assert got.device == gpu and got.dtype == torch.int32
    assert tuple(got.shape) == (8, N_K, 1300)
    bar = engine_bar(got.cpu().numpy(), ref.cpu().numpy())
    assert bar["ok"], bar


def test_kernel_matches_plain_version_on_fixture_block(gpu):
    batch = next(fixture_engine(NAV, 1.0).batches(8))
    inputs = tkp.prepare_kp_inputs(batch, N_K * 1300, pad_epochs=8, device=gpu)
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K).cpu().numpy()
    ref = tkp.synth_kp_packed_ref(inputs, N_K).cpu().numpy()
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size


@pytest.mark.parametrize("name", list(KP_INSTANTIATIONS))
def test_kernel_reproduces_the_recorded_digests(gpu, name):
    """The same bits, on the five synthetic cases at C = 2, 8 and 16 and
    on the fixture block (harness.kp_digest_cases)."""
    want = json.loads(DIGESTS.read_text())["digests"][name]
    got = kp_digests(synth_kp_cuda, name, NAV, gpu)
    differ = sorted(key for key in want if got.get(key) != want[key])
    assert set(got) == set(want) and not differ, differ


def test_wrapper_refuses_operands_off_the_card(gpu):
    inputs = synthetic_kp_inputs(8, 8, 7, "random", gpu)
    inputs["vpack_rs"] = inputs["vpack_rs"].cpu()
    before = synth_kp_cuda.launch_count
    with pytest.raises(ValueError, match="vpack_rs"):
        synth_kp_cuda.synth_kp_packed(inputs, N_K)
    assert synth_kp_cuda.launch_count == before


def test_stream_on_the_card_goes_through_the_kernel(gpu):
    before = synth_kp_cuda.launch_count
    sink = _Collect()
    stats = StreamingSynthesizer(fixture_engine(NAV, 1.6), sink, device=gpu).run()
    assert synth_kp_cuda.launch_count - before == 2  # 15 epochs, B = 8
    assert stats.epochs == 15
    cpu_sink = _Collect()
    StreamingSynthesizer(fixture_engine(NAV, 1.6), cpu_sink, device=CPU).run()
    got, ref = sink.stream(), cpu_sink.stream()
    assert got.size == 15 * 2 * 260000
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


def test_pipelined_stream_on_the_card(gpu):
    """Depth 3: the producer thread's kernels, copies and events stay on
    the run's device; the stream equals the depth-1 stream byte for byte,
    with the same launches."""
    runs = {}
    for depth in (1, 3):
        before = synth_kp_cuda.launch_count
        sink = _Collect()
        stats = StreamingSynthesizer(fixture_engine(NAV, 1.6), sink, device=gpu,
                                     pipeline_depth=depth).run()
        assert stats.epochs == 15
        runs[depth] = (sink.stream(), synth_kp_cuda.launch_count - before)
    assert runs[3][1] == runs[1][1] == 2
    np.testing.assert_array_equal(runs[3][0], runs[1][0])


@pytest.mark.parametrize("depth", [1, 3])
def test_device_resident_drain_on_the_card(gpu, depth):
    """drain_host=False hands the sink CUDA tensors; its on-card sums of
    |x| equal the host drain's block for block."""
    dev, host = AbsSumSink(), AbsSumSink()
    StreamingSynthesizer(fixture_engine(NAV, 1.6), dev, device=gpu, drain_host=False,
                         pipeline_depth=depth).run()
    StreamingSynthesizer(fixture_engine(NAV, 1.6), host, device=gpu).run()
    assert dev.kinds == ["cuda", "cuda"] and host.kinds == ["numpy", "numpy"]
    assert dev.sums == host.sums and all(v > 0 for v in dev.sums)


@pytest.mark.parametrize("mode", ["lut512", "float"])
def test_direct_engine_on_the_card(gpu, mode):
    batch = next(fixture_engine(NAV, 1.0).batches(2))
    tile, ns = 2048, 26000
    dev = tsynth.prepare_device_inputs(batch, tile, ns, device=gpu)
    host = tsynth.prepare_device_inputs(batch, tile, ns, device=CPU)
    got = tsynth.synth_block(dev, tile=tile, mode=mode).cpu().numpy()
    ref = tsynth.synth_block(host, tile=tile, mode=mode).numpy()
    if mode == "lut512":
        np.testing.assert_array_equal(got, ref)
    else:
        bar = engine_bar(got, ref)
        assert bar["ok"], bar


# --- the CBOC and gain instantiations, the int16 view, the band limit ------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", KP_CS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_instantiation_matches_plain_version(gpu, variant, C, case):
    inputs = synthetic_kp_inputs(8, C, 9, case, gpu, **VARIANTS[variant])
    name = f"synth_kp_v5_{variant}"
    before = synth_kp_cuda.launch_counts[name]
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
    assert synth_kp_cuda.launch_counts[name] == before + 1
    ref = tkp.synth_kp_packed_ref(inputs, N_K)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (8, N_K, 1300)
    bar = (cboc_bar if "cboc" in variant else engine_bar)(got, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_instantiation_matches_plain_version_on_fixture_block(gpu, variant):
    cboc = "cboc" in variant
    batch = next(fixture_engine(NAV, 1.0, E1_CBOC if cboc else E1_OS).batches(8))
    inputs = tkp.prepare_kp_inputs(
        batch, N_K * 1300, pad_epochs=8, device=gpu, apply_gain="gain" in variant
    )
    assert synth_kp_cuda.instantiation(inputs) == f"synth_kp_v5_{variant}"
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K).cpu().numpy()
    ref = tkp.synth_kp_packed_ref(inputs, N_K).cpu().numpy()
    bar = (cboc_bar if cboc else engine_bar)(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size


def test_int16_view(gpu):
    inputs = synthetic_kp_inputs(8, 8, 11, "random", gpu, cboc=True, gain=True)
    before = synth_kp_cuda.int16_launch_count
    got = synth_kp_cuda.synth_kp_int16(inputs, N_K)
    assert synth_kp_cuda.int16_launch_count == before + 1
    assert got.device == gpu and got.dtype == torch.int16 and tuple(got.shape) == (8, 2 * N_K * 1300)
    packed = synth_kp_cuda.synth_kp_packed(inputs, N_K)
    np.testing.assert_array_equal(got.cpu().numpy(), tkp.packed_to_iq16(packed.cpu().numpy()))
    bar = cboc_bar(got, tkp.synth_kp_int16_ref(inputs, N_K))
    assert bar["ok"], bar


def test_bandlimit_filter_on_the_card(gpu):
    """The same full-size phase stack and history through the filter on
    the card and on the CPU: full float32 on both."""
    rng = np.random.default_rng(5)
    stacked = torch.from_numpy(rng.integers(-2500, 2500, (12, 8, 2 * 260000)).astype(np.int16))
    hist = torch.from_numpy(rng.uniform(-2000, 2000, (2, 12, 32)).astype(np.float32))
    got, got_hist = tbl.filter_block(stacked.to(gpu), hist.to(gpu), 7)
    ref, ref_hist = tbl.filter_block(stacked, hist, 7)
    diff = np.abs(got.cpu().numpy().astype(np.int32) - ref.numpy().astype(np.int32))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, ((diff == 0).mean(), diff.max())
    assert torch.equal(got_hist.cpu(), ref_hist)


def test_bandlimit_stream_on_the_card(gpu):
    """7 epochs of the CBOC fixture scene in blocks of 4 (a full and a
    partial block), with gain, on the card and on the CPU."""
    kw = dict(bandlimit=True, apply_gain=True, block_epochs=4)
    before = synth_kp_cuda.launch_counts["synth_kp_v5_cboc_gain"]
    sink = _Collect()
    stats = StreamingSynthesizer(fixture_engine(NAV, 0.8, E1_CBOC), sink, device=gpu, **kw).run()
    assert synth_kp_cuda.launch_counts["synth_kp_v5_cboc_gain"] - before == 2 * 12
    assert stats.epochs == 7
    cpu_sink = _Collect()
    StreamingSynthesizer(fixture_engine(NAV, 0.8, E1_CBOC), cpu_sink, device=CPU, **kw).run()
    got, ref = sink.stream(), cpu_sink.stream()
    assert got.size == 7 * 2 * 260000
    xs_g, xs_c, caches = [], [], ({}, {})
    for batch in fixture_engine(NAV, 0.8, E1_CBOC).batches(4):
        n = batch.f_code.shape[0]
        for xs, dev, cache in ((xs_g, gpu, caches[0]), (xs_c, CPU, caches[1])):
            x = tbl.synth_phases(batch, 260000, 4, cache, True, device=dev)
            xs.append(x.cpu().numpy()[:, :n].reshape(12, -1))
    x_g, x_c = np.concatenate(xs_g, axis=1), np.concatenate(xs_c, axis=1)
    bar = cboc_bar(x_g, x_c)
    assert bar["ok"], bar
    bar = bandlimit_bar(got, ref, x_g, x_c)
    assert bar["ok"], bar


# --- the f32 emit (kernel 2) and the shared-GPU refusal ----------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", KP_CS)
@pytest.mark.parametrize("cboc", [False, True])
def test_f32_emit_matches_plain_version(gpu, cboc, C, case):
    inputs = synthetic_kp_inputs(8, C, 13, case, gpu, cboc=cboc)
    name = "synth_kp_v5_cboc_f32" if cboc else "synth_kp_v5_f32"
    before = synth_kp_cuda.launch_counts[name]
    got = synth_kp_cuda.synth_kp_accum(inputs, N_K)
    assert synth_kp_cuda.launch_counts[name] == before + 1
    ref = tkp.synth_kp_accum_ref(inputs, N_K)
    torch.cuda.synchronize()
    assert got.device == gpu and got.dtype == torch.float32
    assert tuple(got.shape) == (8, N_K * 1300, 2)
    bar = (cboc_bar if cboc else engine_bar)(tkp.pack_iq(got), tkp.pack_iq(ref))
    assert bar["ok"], bar
    assert torch.equal(tkp.pack_iq(got), synth_kp_cuda.synth_kp_packed(inputs, N_K))


@pytest.mark.parametrize("cboc", [False, True])
def test_f32_emit_on_an_uncompacted_fixture_block(gpu, cboc):
    """All 16 channel slots, as the sat-sharded mesh prepares them."""
    model = E1_CBOC if cboc else E1_OS
    batch = next(fixture_engine(NAV, 1.0, model).batches(8))
    inputs = tkp.prepare_kp_inputs(batch, N_K * 1300, pad_epochs=8, device=gpu, compact=False)
    assert inputs["cp0"].shape == (8, 16)
    got = synth_kp_cuda.synth_kp_accum(inputs, N_K)
    bar = (cboc_bar if cboc else engine_bar)(tkp.pack_iq(got), tkp.pack_iq(tkp.synth_kp_accum_ref(inputs, N_K)))
    assert bar["ok"], bar
    assert torch.equal(tkp.pack_iq(got), synth_kp_cuda.synth_kp_packed(inputs, N_K))


def test_f32_emit_refuses_gain(gpu):
    inputs = synthetic_kp_inputs(8, 8, 13, "random", gpu, gain=True)
    before = synth_kp_cuda.launch_count
    with pytest.raises(ValueError, match="gain"):
        synth_kp_cuda.synth_kp_accum(inputs, N_K)
    assert synth_kp_cuda.launch_count == before


def test_nccl_refuses_two_ranks_on_one_gpu(gpu, tmp_path):
    """Two NCCL ranks placed on cuda:0: `make_mesh` raises a clear error
    (checked over a gloo group, before any NCCL collective) instead of
    switching backend or hanging."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(DIST_WORKER), "nccl_shared", init, "2", str(rank), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK {rank} OK" in out, out[-3000:]
        assert "REFUSED" in out and "NCCL cannot run two ranks on one GPU" in out, out[-3000:]


# --- the kap grid and the gather probe ---------------------------------------


def test_launch_refuses_a_chunk_off_the_kap_grid(gpu):
    """The main loop takes rows in groups of 8: the entry point of the pair
    refuses a K chunk that is not a multiple of 8 (the wrapper never asks
    for one) before it launches anything, and a window table of another
    width than the source's T_RS."""
    lib, _ = synth_kp_cuda.library()
    inputs = synthetic_kp_inputs(8, 8, 42, "random", gpu)
    planes = torch.empty(synth_kp_cuda.planes_bytes(8, 8, N_K), dtype=torch.uint8, device=gpu)
    out = torch.zeros((8, N_K, 1300), dtype=torch.int32, device=gpu)
    stream = torch.cuda.current_stream(gpu).cuda_stream
    operands = [inputs[k].data_ptr() for k in synth_kp_cuda.PLANE_OPERANDS]
    table = inputs["vpack_rs"].data_ptr()

    def pair(chunk: int, t_rs: int) -> int:
        return lib.synth_kp_v5_pair_launch(
            *operands, table, inputs["sym_bits"].data_ptr(), inputs["pil_bits"].data_ptr(), None,
            planes.data_ptr(), out.data_ptr(), 0.0, 0.0, 0, 0, 8, 8, N_K, chunk, t_rs, stream)

    for chunk in (36, 0):
        assert pair(chunk, tkp.T_RS) != 0
    assert pair(40, tkp.T_RS - 16) != 0
    assert lib.synth_kp_v5_planes_launch(*operands, table, planes.data_ptr(), 8, 8, N_K,
                                         tkp.T_RS - 16, stream) != 0
    torch.cuda.synchronize()
    assert not out.any()  # nothing ran
    assert pair(40, tkp.T_RS) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, synth_kp_cuda.synth_kp_packed(inputs, N_K))


def test_sizes_agree_with_the_source(gpu):
    """The wrappers' shared-memory and scratch sizes and launch geometry
    are the sources'."""
    import ctypes

    lib, _ = synth_kp_cuda.library()
    for C in (1, 2, 8, 16):
        for k in (8, 16, 40):
            assert lib.synth_kp_v5_smem_bytes(C, k) == synth_kp_cuda.smem_bytes(C, k)
        for B in (1, 8):
            assert lib.synth_kp_v5_planes_bytes(B, C, N_K) == synth_kp_cuda.planes_bytes(B, C, N_K)
            for n_k in (8, N_K, 240):
                out = (ctypes.c_int * 8)()
                chunk = synth_kp_cuda.k_chunk(B, C, n_k)
                lib.synth_kp_v5_geometry(B, C, n_k, chunk, out)
                pro, main = synth_kp_cuda.launch_geometry(B, C, n_k)
                assert tuple(out) == (*pro[0], pro[1], *main[0], main[1])
    glib, _ = gather_probe.library()
    for rows, cols, axis in [(*shape, axis) for shape, _, axis in gather_probe.PROBES] + [
            (40, 72, 0), (3, 2052, 1), (130, 36, 0)]:
        out = (ctypes.c_int * 4)()
        glib.gather_probe_geometry(rows, cols, axis, out)
        grid, threads = gather_probe.launch_geometry(rows, cols, axis)
        assert tuple(out) == (*grid, threads)
        assert glib.gather_probe_tile_bytes(rows, cols, axis) == gather_probe.tile_bytes(rows, cols, axis)


@pytest.mark.parametrize("name", list(KP_INSTANTIATIONS))
def test_pair_on_another_stream_and_thread_gives_the_same_bytes(gpu, name):
    """The pair of launches (the main kernel a programmatic dependent of
    the prologue) on the default stream, on a stream of its own, and from
    a second thread on a stream of its own, 20 calls in a row each: every
    output equals the first byte for byte, with one prologue launch for
    every main launch."""
    import threading

    variant, f32 = KP_INSTANTIATIONS[name]
    fn = synth_kp_cuda.synth_kp_accum if f32 else synth_kp_cuda.synth_kp_packed
    cases = [synthetic_kp_inputs(B, 8, 29 + B, "random", gpu, **variant) for B in (8, 1)]
    want = [fn(inputs, N_K) for inputs in cases]
    torch.cuda.synchronize()
    before = dict(synth_kp_cuda.launch_counts)

    def burst(results: list) -> None:
        with torch.cuda.device(gpu):
            stream = torch.cuda.Stream(gpu)
            stream.wait_stream(torch.cuda.default_stream(gpu))
            with torch.cuda.stream(stream):
                for _ in range(10):
                    results.extend(fn(inputs, N_K) for inputs in cases)
            stream.synchronize()

    here, there = [], []
    burst(here)
    thread = threading.Thread(target=burst, args=(there,))
    thread.start()
    thread.join()
    assert len(here) == len(there) == 20
    for i, out in enumerate(here + there):
        assert torch.equal(out, want[i % 2]), i
    assert synth_kp_cuda.launch_counts[name] - before[name] == 40
    assert synth_kp_cuda.launch_counts[synth_kp_cuda.PLANES] - before[synth_kp_cuda.PLANES] == 40


def test_launch_floor_is_below_the_kernels(gpu):
    """The empty kernel of the pair's grids takes less than the pair, and
    more than nothing."""
    from galileo_sdr_sim_tpu_torch.ops import measure

    inputs = synthetic_kp_inputs(8, 8, 31, "random", gpu)
    floor = measure.floor_ms(synth_kp_cuda.launch_geometry(8, 8, N_K))
    pair = measure.median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
    assert 0.0 < floor < pair, (floor, pair)


@pytest.mark.parametrize("case", ["random", "edges", "negated_mu"])
@pytest.mark.parametrize("C", KP_CS)
def test_prologue_kernel_matches_kp_planes_ref(gpu, C, case):
    """The prologue kernel's planes against the plain version's: psi, w8,
    the chip and bits words exactly; cos and sin of the K factor within
    2^-22 (the kernel's precise cosf/sinf against float64 rounded once),
    of the p factor within 2^-17: there the kernel contracts carr0 +
    fc*p into one FMA (-fmad=true) and the plain version rounds twice, so
    the phase, of magnitude below 8 before its fraction is taken, may
    differ by a float32 ulp (2^-21), 2*pi times that in the angle."""
    inputs = synthetic_kp_inputs(8, C, 17, case, gpu, cboc=case == "edges")
    before = synth_kp_cuda.launch_counts[synth_kp_cuda.PLANES]
    got = synth_kp_cuda.kp_planes(inputs, N_K)
    assert synth_kp_cuda.launch_counts[synth_kp_cuda.PLANES] == before + 1
    ref = tkp.kp_planes_ref(inputs, N_K)
    for key in ("chip", "bits"):
        assert torch.equal(got[key], ref[key]), key
    assert torch.equal(got["plf"][..., :2], ref["plf"][..., :2])
    assert float((got["plf"][..., 2:] - ref["plf"][..., 2:]).abs().max()) <= 2.0**-17
    assert float((got["cisk"] - ref["cisk"]).abs().max()) <= 2.0**-22


@pytest.mark.parametrize("name", list(KP_INSTANTIATIONS))
def test_one_epoch_blocks_equal_the_eight_epoch_block(gpu, name):
    """Live mode's B = 1 blocks (K chunks of 8 rows) give each epoch of a
    B = 8 block (chunks of 40) bit for bit: an epoch's output depends on
    its own operands only."""
    variant, f32 = KP_INSTANTIATIONS[name]
    inputs = synthetic_kp_inputs(8, 8, 19, "edges", gpu, **variant)
    fn = synth_kp_cuda.synth_kp_accum if f32 else synth_kp_cuda.synth_kp_packed
    whole = fn(inputs, N_K)
    for b in range(8):
        one = {k: v[b:b + 1].contiguous() if v.dim() == 2 else v for k, v in inputs.items()}
        assert torch.equal(fn(one, N_K), whole[b:b + 1]), b


@pytest.mark.parametrize("probe", gather_probe.PROBES)
def test_gather_kernel_equals_take_along_dim(gpu, probe):
    shape, maxidx, axis = probe
    gen = torch.Generator().manual_seed(3)
    tab, idx = gather_probe.probe_inputs(shape, maxidx, gen)
    before = gather_probe.launch_count
    got = gather_probe.take_along_axis(tab.to(gpu), idx.to(gpu), axis)
    assert gather_probe.launch_count == before + 1
    assert got.device == gpu and got.dtype == torch.int32
    assert torch.equal(got, torch.take_along_dim(tab.to(gpu), idx.to(gpu).long(), dim=axis))
    assert torch.equal(got.cpu(), gather_probe.take_along_axis_ref(tab, idx, axis))


@pytest.mark.parametrize("shape, axis", [((40, 72), 0), ((40, 72), 1), ((3, 2052), 1),
                                         ((130, 36), 0), ((1500, 32), 0), ((2, 57344), 1)])
def test_gather_kernel_on_ragged_and_large_tiles(gpu, shape, axis):
    """Partial column tiles and row chunks, a row longer than one block's
    outputs, and slices above 48 KB of shared memory (192000 and 229376
    bytes), with a few indices outside the table."""
    gen = torch.Generator().manual_seed(5)
    tab, idx = gather_probe.probe_inputs(shape, shape[axis], gen)
    idx[0, :3] = torch.tensor([-1, shape[axis], 2**31 - 1], dtype=torch.int32)
    got = gather_probe.take_along_axis(tab.to(gpu), idx.to(gpu), axis).cpu()
    assert torch.equal(got, gather_probe.take_along_axis_ref(tab, idx, axis))


def test_gather_probe_main_on_the_card(gpu, capsys):
    before = gather_probe.launch_count
    assert gather_probe.main([]) == 0
    assert gather_probe.launch_count == before + len(gather_probe.PROBES)
    assert capsys.readouterr().out.count("CORRECT") == len(gather_probe.PROBES)


def test_gather_kernel_gives_zero_outside_the_table(gpu):
    """An index outside [0, n) gives 0, as the plain version gives, and
    the kernel reads nothing outside the table."""
    for shape, maxidx, axis in ((8, 128), 128, 1), ((128, 128), 128, 0):
        gen = torch.Generator().manual_seed(4)
        tab, idx = gather_probe.probe_inputs(shape, maxidx, gen)
        idx[0, :3] = torch.tensor([-1, shape[axis], 2**31 - 1], dtype=torch.int32)
        got = gather_probe.take_along_axis(tab.to(gpu), idx.to(gpu), axis).cpu()
        assert torch.equal(got, gather_probe.take_along_axis_ref(tab, idx, axis))
        assert torch.equal(got[0, :3], torch.zeros(3, dtype=torch.int32))
