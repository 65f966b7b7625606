"""`--trace-dir` on the CPU: the port's CLI runs the stream under
torch.profiler (profiling.trace, the counterpart of the JAX package's
jax.profiler trace) and writes a TensorBoard-loadable Chrome trace that
names the stream's stages with ranges of their Timer sections.  Tracing
changes no byte of the output."""

import json

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu_torch import cli
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.profiling import trace

from _torch_parity import CPU, LLH, NAV, START, fixture_engine
from conftest import CollectSink

STAGES = {"scenario", "host_prep+dispatch", "device_wait+fetch", "sink_write"}


def _events(trace_dir) -> list:
    (path,) = trace_dir.glob("*.pt.trace.json")
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _ranges(events) -> list:
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_trace_dir_writes_a_trace_and_changes_no_byte(tmp_path):
    static = tmp_path / "static.csv"
    static.write_text(",".join(str(v) for v in LLH) + "\n")
    argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "1", "-t", START, "-u", str(static),
            "--device", "cpu"]
    plain, traced = tmp_path / "plain.ishort", tmp_path / "traced.ishort"
    assert cli.main([*argv, "-o", str(plain)]) == 0
    assert cli.main([*argv, "-o", str(traced), "--trace-dir", str(tmp_path / "trace")]) == 0
    assert plain.read_bytes() == traced.read_bytes()
    assert plain.stat().st_size == 9 * 260000 * 4
    assert STAGES <= set(_ranges(_events(tmp_path / "trace")))


def test_stage_ranges_follow_the_timer_sections(tmp_path):
    """One range a Timer section entry, of the same name."""
    synth = StreamingSynthesizer(fixture_engine(1.0), CollectSink(), device=CPU, block_epochs=2,
                                 nsamples=10400)
    with trace(tmp_path, CPU):
        stats = synth.run()
    ranges = _ranges(_events(tmp_path))
    assert {name: ranges.count(name) for name in set(ranges)} == stats.timer.counts
    assert stats.timer.counts["host_prep+dispatch"] == 5


def test_trace_is_written_and_the_profiler_stopped_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(tmp_path / "a", "cpu"):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert any(e["name"] == "aten::sum" for e in _events(tmp_path / "a"))
    with trace(tmp_path / "b", CPU):  # a second profiler starts: the first one stopped
        np.ones(3)
    assert _events(tmp_path / "b") is not None
