"""The whole slice on the CPU: the port's CLI and streaming executor
against the JAX package's StreamingSynthesizer over the same fixture
scene.  Float-carrier sine-BOC streams are held to the engine bar (>=
99.9% of int16 values identical, every difference within 4 *
LUT_AMPLITUDE = 1000), CBOC streams to `cboc_bar` (>= 99.8%, within
1000); lut512 streams must be byte-identical.  Band-limited streams are
held to the per-sample bound |y_port - y_jax| <= (|K| * |x_port -
x_jax|) + 2 (`bandlimit_bar`), with x the 12 phase streams of the same
blocks made by each package, which themselves meet `cboc_bar`."""

import dataclasses

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer as JaxStream
from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.models.e1 import E1_OS
from galileo_sdr_sim_tpu.ops import bandlimit as jbl
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu_torch import cli
from galileo_sdr_sim_tpu_torch.device import resolve_device
from galileo_sdr_sim_tpu_torch.harness import bandlimit_bar, cboc_bar, engine_bar
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.ops import bandlimit as tbl
from galileo_sdr_sim_tpu_torch.ops.synth_kp import mu_in_envelope
from galileo_sdr_sim_tpu_torch.parallel.distributed import ENV_COORD

from _torch_parity import CPU, LLH, NAV, START, fixture_engine
from conftest import CollectSink

NS = 10400  # 8 x 1300-sample test epochs


def _jax_stream(engine, **kw) -> np.ndarray:
    sink = CollectSink()
    JaxStream(engine, sink, **kw).run()
    return np.concatenate([b.reshape(-1) for b in sink.blocks])


def _torch_stream(engine, **kw):
    sink = CollectSink()
    synth = StreamingSynthesizer(engine, sink, device=CPU, **kw)
    stats = synth.run()
    return np.concatenate([b.reshape(-1) for b in sink.blocks]), stats


def _phase_streams(batches, nsamples, block_epochs, apply_gain):
    """The 12 phase streams of each block's real epochs, (12, n) int16
    flat in stream order, from the port and from the JAX package."""
    xs_t, xs_j, cache = [], [], {}
    for batch in batches:
        n = batch.f_code.shape[0]
        x_t = tbl.synth_phases(batch, nsamples, block_epochs, cache, apply_gain, device=CPU)
        x_j = np.stack([
            np.asarray(jkp.synth_block_kp(
                jkp.prepare_kp_inputs(jbl.phase_shift_batch(batch, j), nsamples,
                                      pad_epochs=block_epochs, apply_gain=apply_gain),
                n_k=nsamples // 1300, engine="xla"))
            for j in range(12)
        ])
        xs_t.append(x_t.numpy()[:, :n].reshape(12, -1))
        xs_j.append(x_j[:, :n].reshape(12, -1))
    return np.concatenate(xs_t, axis=1), np.concatenate(xs_j, axis=1)


def _assert_bandlimited_pair(got, ref, batches, nsamples, block_epochs, apply_gain):
    x_t, x_j = _phase_streams(batches, nsamples, block_epochs, apply_gain)
    bar = cboc_bar(x_t, x_j)
    assert bar["ok"], bar
    bar = bandlimit_bar(got, ref, x_t, x_j)
    assert bar["ok"], bar


class _Teleport:
    """Fixture scene whose second epoch has a code Doppler far outside
    the kp envelope in one channel, as a live-position teleport gives."""

    def __init__(self, duration_s, model=E1_OS):
        self._engine = fixture_engine(duration_s, model)
        self.model = self._engine.model

    def batches(self, block_epochs, start=1):
        for i, b in enumerate(self._engine.batches(block_epochs, start=start)):
            if i == 0:
                f_code = b.f_code.copy()
                f_code[1, 0] += 40.0
                b = dataclasses.replace(b, f_code=f_code)
            yield b


def test_cli_main_on_cpu_matches_jax_stream(tmp_path):
    """`cli.main --device cpu` on the fixture nav file for 0.8 s (7
    epochs, one B=8 block through the kp path).  A one-row user-motion
    file keeps the run off the fixed UDP position port."""
    um = tmp_path / "static.csv"
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    out = tmp_path / "port.ishort"
    rc = cli.main([
        "-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.8", "-t", START,
        "-l", ",".join(str(v) for v in LLH), "-o", str(out),
        "--device", "cpu", "-u", str(um),
    ])
    assert rc == 0
    got = np.fromfile(out, dtype=np.int16)
    assert got.size * 2 == 7 * 260000 * 4
    ref = _jax_stream(fixture_engine(0.8), synth_engine="kp")
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


def test_cli_checkpoint_and_pipeline_depth_match_the_jax_cli(tmp_path, monkeypatch):
    """`--checkpoint FILE --pipeline-depth 3` reach the executor.  From one
    snapshot after the first 8 of 15 epochs, the port's CLI (--device
    cpu) and the JAX package's CLI each resume at epoch 9 and rewrite
    their output file from there ("wb"): the port's file is the tail of
    its uninterrupted depth-1 file byte for byte, and meets the engine
    bar against the JAX CLI's file."""
    from galileo_sdr_sim_tpu.cli import main as jax_main
    from galileo_sdr_sim_tpu_torch.checkpoint import save_state

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    um = tmp_path / "static.csv"
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    base = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "1.6", "-t", START,
            "-l", ",".join(str(v) for v in LLH), "-u", str(um)]
    full = tmp_path / "full.ishort"
    assert cli.main([*base, "-o", str(full), "--device", "cpu"]) == 0
    engine, servers = cli.build_engine(cli.build_torch_parser().parse_args([*base, "--device", "cpu"]))
    assert servers is None
    engine._replay_keep = 16  # as the executor sets it: the rewind below
    next(engine.batches(8))
    for name in ("port", "jax"):
        save_state(engine, tmp_path / f"{name}.ckpt", drained_iumd=8)
    port, jax_out = tmp_path / "port.ishort", tmp_path / "jax.ishort"
    port.write_bytes(b"\xff" * 64)  # rewritten, not appended to
    resume = ["--pipeline-depth", "3", "--checkpoint"]
    assert cli.main([*base, "-o", str(port), "--device", "cpu", *resume,
                     str(tmp_path / "port.ckpt")]) == 0
    assert jax_main([*base, "-o", str(jax_out), *resume, str(tmp_path / "jax.ckpt")]) == 0
    got, whole = np.fromfile(port, dtype=np.int16), np.fromfile(full, dtype=np.int16)
    n = 2 * 260000
    assert whole.size == 15 * n and got.size == 7 * n
    np.testing.assert_array_equal(got, whole[8 * n:])
    bar = engine_bar(got, np.fromfile(jax_out, dtype=np.int16))
    assert bar["ok"], bar


def test_stream_kp_path_and_stages():
    got, stats = _torch_stream(fixture_engine(0.5), nsamples=10400)
    ref = _jax_stream(fixture_engine(0.5), synth_engine="kp", nsamples=10400)
    assert stats.epochs == 4 and stats.samples == 4 * 10400
    assert engine_bar(got, ref)["ok"]
    assert {"scenario", "host_prep+dispatch", "device_wait+fetch", "sink_write"} <= set(
        stats.timer.sections
    )


def test_stream_lut512_is_byte_identical():
    got, _ = _torch_stream(fixture_engine(0.5), mode="lut512", nsamples=10400, tile=2048)
    ref = _jax_stream(fixture_engine(0.5), mode="lut512", nsamples=10400, tile=2048)
    np.testing.assert_array_equal(got, ref)


def test_stream_out_of_envelope_epoch_goes_direct():
    got, stats = _torch_stream(_Teleport(0.5), nsamples=10400, tile=2048)
    ref = _jax_stream(_Teleport(0.5), synth_engine="kp", nsamples=10400, tile=2048)
    assert "fallback_direct" in stats.timer.sections
    assert "host_prep+dispatch" not in stats.timer.sections
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


# --- CBOC, gain and the band-limited stream -------------------------------


@pytest.mark.parametrize("apply_gain", [False, True])
def test_stream_cboc_matches_jax(apply_gain):
    kw = dict(nsamples=NS, apply_gain=apply_gain, block_epochs=3)
    got, stats = _torch_stream(fixture_engine(0.5, E1_CBOC), **kw)
    ref = _jax_stream(fixture_engine(0.5, E1_CBOC), synth_engine="kp", **kw)
    assert stats.epochs == 4 and got.size == ref.size == 4 * 2 * NS
    bar = cboc_bar(got, ref)
    assert bar["ok"], bar


def test_stream_gain_matches_jax():
    kw = dict(nsamples=NS, apply_gain=True)
    got, _ = _torch_stream(fixture_engine(0.5), **kw)
    ref = _jax_stream(fixture_engine(0.5), synth_engine="kp", **kw)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    plain, _ = _torch_stream(fixture_engine(0.5), nsamples=NS)
    assert (got != plain).mean() > 0.5  # the gain is applied


@pytest.mark.parametrize("apply_gain", [False, True])
def test_stream_bandlimit_matches_jax(apply_gain):
    """Blocks of 3 epochs, the second a partial one (1 epoch): the overlap
    state crosses a block edge and a partial block in both packages."""
    kw = dict(nsamples=NS, apply_gain=apply_gain, block_epochs=3, bandlimit=True)
    got, stats = _torch_stream(fixture_engine(0.5, E1_CBOC), **kw)
    ref = _jax_stream(fixture_engine(0.5, E1_CBOC), synth_engine="kp", **kw)
    assert stats.epochs == 4 and got.size == ref.size
    assert {"scenario", "host_prep+dispatch", "device_wait+fetch", "sink_write"} <= set(
        stats.timer.sections
    )
    batches = list(fixture_engine(0.5, E1_CBOC).batches(3))
    _assert_bandlimited_pair(got, ref, batches, NS, 3, apply_gain)


def test_bandlimit_fallback_block_is_pointwise_and_keeps_the_state():
    """The documented seam (docs/bandlimit.md, known seams), on both
    sides: a block with an epoch outside the kp envelope goes pointwise
    through the direct engine, and the next block filters from the
    overlap state the fallback block left untouched (here the zero
    state)."""
    kw = dict(nsamples=NS, tile=2048, block_epochs=2, bandlimit=True)
    got, stats = _torch_stream(_Teleport(0.5, E1_CBOC), **kw)
    ref = _jax_stream(_Teleport(0.5, E1_CBOC), synth_engine="kp", **kw)
    assert "fallback_direct" in stats.timer.sections
    batches = list(_Teleport(0.5, E1_CBOC).batches(2))
    assert [mu_in_envelope(b.f_code) for b in batches] == [False, True]
    cut = 2 * 2 * NS  # the fallback block: 2 epochs of interleaved I/Q
    bar = cboc_bar(got[:cut], ref[:cut])
    assert bar["ok"], bar
    _assert_bandlimited_pair(got[cut:], ref[cut:], batches[1:], NS, 2, False)
    fresh, _ = tbl.synth_block_cboc_bandlimited(batches[1], NS, pad_epochs=2, device=CPU)
    np.testing.assert_array_equal(got[cut:], fresh.numpy().reshape(-1))


def test_direct_fallback_ignores_gain():
    """As in the JAX executor, a fallback block is synthesized without
    the per-channel gain; the kp blocks around it carry it."""
    kw = dict(nsamples=NS, tile=2048, block_epochs=2)
    with_gain, _ = _torch_stream(_Teleport(0.5), apply_gain=True, **kw)
    without, _ = _torch_stream(_Teleport(0.5), **kw)
    ref = _jax_stream(_Teleport(0.5), synth_engine="kp", apply_gain=True, **kw)
    cut = 2 * 2 * NS
    np.testing.assert_array_equal(with_gain[:cut], without[:cut])
    assert (with_gain[cut:] != without[cut:]).mean() > 0.5
    bar = engine_bar(with_gain, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("option", [
    dict(synth_engine="direct"), dict(mode="lut512"), dict(nsamples=26000),
])
def test_bandlimit_needs_the_kp_engine(option):
    for Stream, kw in ((JaxStream, {}), (StreamingSynthesizer, dict(device=CPU))):
        with pytest.raises(ValueError, match="factorized"):
            Stream(fixture_engine(0.3, E1_CBOC), CollectSink(), bandlimit=True, **option, **kw)


def test_bandlimit_needs_the_cboc_model():
    for Stream, kw in ((JaxStream, {}), (StreamingSynthesizer, dict(device=CPU))):
        with pytest.raises(ValueError, match="CBOC"):
            Stream(fixture_engine(0.3), CollectSink(), bandlimit=True, **kw)


def test_other_signal_geometries_route_direct():
    engine = fixture_engine(0.3)
    engine.model = dataclasses.replace(E1_CBOC, code_subdiv=4)
    assert StreamingSynthesizer(engine, CollectSink(), device=CPU).synth_engine == "direct"
    assert StreamingSynthesizer(fixture_engine(0.3, E1_CBOC), CollectSink(), device=CPU).synth_engine == "kp"


@pytest.mark.parametrize("options", [
    ["--model", "cboc"], ["--apply-gain"], ["--bandlimit"], ["--bandlimit", "--apply-gain"],
])
def test_cli_main_on_cpu_runs_cboc_gain_and_bandlimit(tmp_path, options):
    """`cli.main --device cpu` with each new option, 2 full 0.1 s epochs
    in blocks of 2, against the JAX StreamingSynthesizer on the same
    scene; --bandlimit implies --model cboc on both sides."""
    um = tmp_path / "static.csv"
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    out = tmp_path / "port.ishort"
    rc = cli.main([
        "-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.2", "-t", START,
        "-l", ",".join(str(v) for v in LLH), "-o", str(out),
        "--device", "cpu", "-u", str(um), "--block-epochs", "2", *options,
    ])
    assert rc == 0
    got = np.fromfile(out, dtype=np.int16)
    cboc = "--model" in options or "--bandlimit" in options
    model = E1_CBOC if cboc else E1_OS
    engine = lambda: fixture_engine(0.2, model)  # noqa: E731
    n_epochs = len(engine())
    assert got.size == n_epochs * 2 * 260000
    kw = dict(block_epochs=2, apply_gain="--apply-gain" in options,
              bandlimit="--bandlimit" in options)
    ref = _jax_stream(engine(), synth_engine="kp", **kw)
    if kw["bandlimit"]:
        _assert_bandlimited_pair(got, ref, list(engine().batches(2)), 260000, 2, kw["apply_gain"])
    else:
        bar = (cboc_bar if cboc else engine_bar)(got, ref)
        assert bar["ok"], bar


def test_engine_flag_routes():
    kw = dict(device=CPU)
    for name in ("auto", "kp", "kp_pallas"):
        assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), synth_engine=name, **kw).synth_engine == "kp"
    assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), synth_engine="direct", **kw).synth_engine == "direct"
    assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), mode="lut512", **kw).synth_engine == "direct"


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What the port's CLI still refuses, as the JAX CLI does: no nav
    file, a test-vector file alone, and distributed mode without -U."""
    base = ["-e", str(NAV), "-t", START, "-d", "0.3", "-o", str(tmp_path / "x.ishort"),
            "--device", "cpu"]
    assert cli.main([]) == 1  # no nav file
    assert cli.main(["-n", "tv.bin", "-U", "1"]) == 1  # the vestigial test vectors
    monkeypatch.setenv(ENV_COORD, f"file://{tmp_path / 'never'}")
    assert cli.main(base) == 1  # distributed mode, the USRP sink
    assert not (tmp_path / "x.ishort").exists()


@pytest.mark.parametrize("options, env", [
    (["-n", "tv.bin", "-U", "1"], False),  # test vectors without a nav file
    ([], True),  # distributed mode with the USRP sink
])
def test_cli_refusal_is_one_error_line(tmp_path, capsys, monkeypatch, options, env):
    """A refusal stops the CLI with one ERROR line, exit code 1 and no
    traceback, before anything is written."""
    out = tmp_path / "x.ishort"
    if env:
        monkeypatch.setenv(ENV_COORD, f"file://{tmp_path / 'never'}")
        options = ["-e", str(NAV), "-t", START, "-d", "0.3", "--device", "cpu"]
    rc = cli.main([*options, "-o", str(out)])
    printed, err = capsys.readouterr()
    assert rc == 1
    assert printed.splitlines() == [printed.strip()], printed
    assert printed.startswith("ERROR: ")
    assert "Traceback" not in err
    assert not out.exists()


def test_cuda_requested_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.3", "-t", START,
                  "-o", str(tmp_path / "x.ishort")])
    assert resolve_device("cpu") == torch.device("cpu")
