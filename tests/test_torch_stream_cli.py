"""The whole slice on the CPU: the port's CLI and streaming executor
against the JAX package's StreamingSynthesizer over the same fixture
scene.  Float-carrier streams are held to the engine bar (>= 99.9% of
int16 values identical, every difference within 4 * LUT_AMPLITUDE =
1000); lut512 streams must be byte-identical."""

import dataclasses

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer as JaxStream
from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch import cli
from galileo_sdr_sim_tpu_torch.device import resolve_device
from galileo_sdr_sim_tpu_torch.harness import engine_bar
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer

from _torch_parity import CPU, LLH, NAV, START, fixture_engine
from conftest import CollectSink


def _jax_stream(engine, **kw) -> np.ndarray:
    sink = CollectSink()
    JaxStream(engine, sink, **kw).run()
    return np.concatenate([b.reshape(-1) for b in sink.blocks])


def _torch_stream(engine, **kw):
    sink = CollectSink()
    synth = StreamingSynthesizer(engine, sink, device=CPU, **kw)
    stats = synth.run()
    return np.concatenate([b.reshape(-1) for b in sink.blocks]), stats


class _Teleport:
    """Fixture scene whose second epoch has a code Doppler far outside
    the kp envelope in one channel, as a live-position teleport gives."""

    def __init__(self, duration_s):
        self._engine = fixture_engine(duration_s)
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


@pytest.mark.parametrize("option", [
    {"pipeline_depth": 2}, {"checkpoint_path": "x.ckpt"}, {"drain_host": False},
    {"bandlimit": True}, {"apply_gain": True},
])
def test_unported_stream_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingSynthesizer(fixture_engine(0.3), CollectSink(), device=CPU, **option)


def test_cboc_model_raises():
    engine = fixture_engine(0.3)
    engine.model = E1_CBOC
    with pytest.raises(NotImplementedError, match="CBOC"):
        StreamingSynthesizer(engine, CollectSink(), device=CPU)


def test_engine_flag_routes():
    kw = dict(device=CPU)
    for name in ("auto", "kp", "kp_pallas"):
        assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), synth_engine=name, **kw).synth_engine == "kp"
    assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), synth_engine="direct", **kw).synth_engine == "direct"
    assert StreamingSynthesizer(fixture_engine(0.3), CollectSink(), mode="lut512", **kw).synth_engine == "direct"


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    base = ["-e", str(NAV), "-t", START, "-d", "0.3", "-o", str(tmp_path / "x.ishort")]
    assert cli.main([]) == 1  # no nav file
    assert cli.main(base) == 1  # USRP sink (no -U)
    assert cli.main(base + ["-U", "1", "--trace-dir", str(tmp_path)]) == 1
    monkeypatch.setenv("GALILEO_COORDINATOR", "localhost:1234")
    assert cli.main(base + ["-U", "1"]) == 1


def test_cuda_requested_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.3", "-t", START,
                  "-o", str(tmp_path / "x.ishort")])
    assert resolve_device("cpu") == torch.device("cpu")
