"""`--trace-dir` on the CPU: the port's CLI runs the stream under
torch.profiler (profiling.trace, the counterpart of the JAX package's
jax.profiler trace) and writes a TensorBoard-loadable Chrome trace that
names what the host did with ranges of its spans (profiling.span): the
stream's stages and, inside them, the scenario engine's, the host prep's
and the file sink's.  Only the innermost open span of a thread holds a
range, so a thread's ranges never overlap; with no profiler running no
range opens.  Tracing changes no byte of the output."""

import dataclasses
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu_torch import cli, profiling, scenario
from galileo_sdr_sim_tpu_torch.channels import regenerate_page
from galileo_sdr_sim_tpu_torch.io.sinks import FileSink
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.profiling import Timer, installed, span, trace
from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3

from _torch_parity import CPU, LLH, NAV, START, fixture_engine
from conftest import CollectSink

STAGES = {"scenario", "host_prep+dispatch", "device_wait+fetch", "sink_write"}
# the spans a run of kp blocks into a FileSink opens (codes once a run);
# scenario/realloc opens only at a 30 s boundary
SPANS = STAGES | {
    "scenario/geometry", "scenario/nav_page", "scenario/pack", "host_prep+dispatch/seed",
    "host_prep+dispatch/codes", "host_prep+dispatch/h2d", "host_prep+dispatch/launch",
    "host_prep+dispatch/fetch", "sink_write/file",
}


def live_engine(duration_s: float) -> scenario.ScenarioEngine:
    """The fixture scene with a live position source at the fixture site,
    as the benchmark's jobs and the command line's UDP position thread
    run it: one `_step_block` a block (a one-epoch chunk at B = 1)."""
    nav = read_rinex_v3(str(NAV))
    llh = np.array(LLH, np.float64)
    g0 = scenario.scenario_start_time(nav, cli._parse_time(START))
    return scenario.ScenarioEngine(nav, scenario.PositionProvider(live=lambda: llh), g0,
                                   duration_s)


def _events(trace_dir) -> list:
    (path,) = trace_dir.glob("*.pt.trace.json")
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _ranges(events) -> list:
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def _plain_and_traced(tmp_path, *options) -> list:
    """The CLI's 1 s file with and without `--trace-dir` -> the trace's
    events, once the two files are byte-identical."""
    static = tmp_path / "static.csv"
    static.write_text(",".join(str(v) for v in LLH) + "\n")
    argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "1", "-t", START, "-u", str(static),
            "--device", "cpu", *options]
    plain, traced = tmp_path / "plain.ishort", tmp_path / "traced.ishort"
    assert cli.main([*argv, "-o", str(plain)]) == 0
    assert cli.main([*argv, "-o", str(traced), "--trace-dir", str(tmp_path / "trace")]) == 0
    assert plain.read_bytes() == traced.read_bytes()
    assert plain.stat().st_size == 9 * 260000 * 4
    return _events(tmp_path / "trace")


def test_trace_dir_writes_a_trace_and_changes_no_byte(tmp_path):
    assert STAGES <= set(_ranges(_plain_and_traced(tmp_path)))


def test_trace_dir_changes_no_byte_at_depth_3(tmp_path):
    """At pipeline depth 3 too the file is the same with and without the
    trace, whose ranges are the draining thread's (the profiler records
    the thread that started it)."""
    events = _plain_and_traced(tmp_path, "--pipeline-depth", "3", "--block-epochs", "2")
    assert {"device_wait+fetch", "sink_write", "sink_write/file"} <= set(_ranges(events))


def test_stage_ranges_follow_the_timer_sections(tmp_path):
    """Under the profiler the innermost open span holds the thread's
    range: no two ranges of a thread overlap; a leaf section has one range
    an entry, a parent one an entry plus one after each child's; and a
    section's ranges add up to its self time (the section less its
    children's) within 5%, beyond four of the trace's typical gaps a
    range: a gap, where one range ends and the next opens, is profiler
    bookkeeping that the Timer holds and no range covers."""
    synth = StreamingSynthesizer(live_engine(3.0), FileSink(tmp_path / "out.ishort"),
                                 device=CPU, block_epochs=2, nsamples=10400)
    with trace(tmp_path / "trace", CPU):
        stats = synth.run()
    events = [e for e in _events(tmp_path / "trace") if e.get("cat") == "user_annotation"]
    by_thread, gaps = defaultdict(list), []
    for e in events:
        by_thread[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for spans in by_thread.values():
        spans.sort()
        for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
            assert start >= end, (a, b, end - start)
            if a.split("/")[0] == b.split("/")[0]:  # a transition inside a stage
                gaps.append((start - end) * 1e-6)
    gap = statistics.median(gaps)
    ranges, seconds = defaultdict(int), defaultdict(float)
    for e in events:
        ranges[e["name"]] += 1
        seconds[e["name"]] += e["dur"] * 1e-6
    counts, sections = stats.timer.counts, stats.timer.sections
    assert set(ranges) == set(counts) >= SPANS
    for name, n in counts.items():
        children = [k for k in counts if k.rsplit("/", 1)[0] == name and "/" in k]
        assert ranges[name] == n + sum(counts[k] for k in children), name
        self_s = sections[name] - sum(sections[k] for k in children)
        slack = 0.05 * self_s + 4 * gap * ranges[name]
        assert abs(seconds[name] - self_s) <= slack, (name, seconds[name], self_s, slack)
    assert counts["host_prep+dispatch"] == counts["host_prep+dispatch/launch"] == 15


def test_no_range_opens_without_a_profiler(monkeypatch, tmp_path):
    """With no profiler running a stream run enters no record_function
    and no range of a span, and still fills every section."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range opened with no profiler running")

    for mod, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (profiling, "_range_enter"), (profiling, "_range_exit")):
        monkeypatch.setattr(mod, name, refuse)
    synth = StreamingSynthesizer(live_engine(3.0), FileSink(tmp_path / "out.ishort"),
                                 device=CPU, block_epochs=2, nsamples=10400)
    stats = synth.run()
    assert set(stats.timer.sections) >= SPANS
    assert all(stats.timer.sections[k] > 0 for k in SPANS)


def test_producer_thread_spans_land_in_the_run_timer():
    """At pipeline depth 3 the producer thread's spans (scenario/*,
    host_prep+dispatch/*) report to the run's Timer, beside the draining
    thread's stages."""
    synth = StreamingSynthesizer(live_engine(3.0), CollectSink(), device=CPU, block_epochs=2,
                                 nsamples=10400, pipeline_depth=3)
    counts = synth.run().timer.counts
    producer = {k for k in SPANS if k.split("/")[0] in ("scenario", "host_prep+dispatch")}
    assert producer <= set(counts)
    assert counts["scenario/pack"] == counts["host_prep+dispatch/seed"] == 15
    assert counts["device_wait+fetch"] == counts["sink_write"] == 15
    assert "sink_write/file" not in counts  # CollectSink is no FileSink


def test_span_counts_are_the_events(monkeypatch):
    """`scenario/nav_page` counts the pages the channels built,
    `scenario/geometry` the chunks stepped, and `host_prep+dispatch/codes`
    the window-table rebuilds: one while the channel map holds."""
    built = []

    def counted(chan, *args):
        built.append(chan.prn)
        return regenerate_page(chan, *args)

    monkeypatch.setattr(scenario, "regenerate_page", counted)
    # one `_step_block` a live epoch at B = 1, a live block at B = 4 and a
    # chunk of 32 static epochs: 59 epochs in 59, 15 and 2 geometry entries
    for engine, block_epochs, geometry in ((live_engine(6.0), 1, 59), (live_engine(6.0), 4, 15),
                                           (fixture_engine(6.0), 4, 2)):
        built.clear()
        synth = StreamingSynthesizer(engine, CollectSink(), device=CPU,
                                     block_epochs=block_epochs, nsamples=10400)
        counts = synth.run().timer.counts
        assert len(built) >= 7 and counts["scenario/nav_page"] == len(built)
        assert counts["host_prep+dispatch/codes"] == 1
        assert counts["scenario/geometry"] == geometry and "scenario/realloc" not in counts


def test_engine_without_a_timer_gives_the_same_tables():
    """A ScenarioEngine stepped with no Timer installed opens no span and
    gives the same batches as one stepped under a Timer."""
    assert profiling._THREAD.stack is None
    plain = list(live_engine(3.0).batches(4))
    timer = Timer()
    with installed(timer):
        timed = list(live_engine(3.0).batches(4))
    assert profiling._THREAD.stack is None
    assert len(plain) == len(timed) == 8
    for a, b in zip(plain, timed):
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert {"geometry", "nav_page", "pack"} <= set(timer.counts)
    # one geometry entry a block: 29 epochs are 7 blocks of 4 and one of 1
    assert timer.counts["geometry"] == 8 and timer.counts["pack"] == 8


def test_span_paths_nesting_and_no_op():
    """A span is a section named by its path in the thread's open spans;
    a parent's section includes its children; every entry counts; an
    exception passes through; one span object may be entered inside
    itself; nothing is recorded with no Timer installed."""
    outer, inner = span("outer"), span("inner")
    with outer, inner:
        pass
    timer = Timer()
    with installed(timer):
        with outer:
            with inner:
                with inner:
                    time.sleep(0.002)
            with pytest.raises(ValueError):
                with inner:
                    raise ValueError("through")
        with inner:
            pass
        other = Timer()
        with outer, installed(other), inner:  # a second Timer starts at top level
            pass
    assert timer.counts == {"outer": 2, "outer/inner": 2, "outer/inner/inner": 1, "inner": 1}
    assert other.counts == {"inner": 1}
    s = timer.sections
    assert s["outer"] >= s["outer/inner"] >= s["outer/inner/inner"] >= 0.002
    lines = timer.report().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "outer", "outer/inner", "outer/inner/inner", "inner"]


def test_trace_is_written_and_the_profiler_stopped_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(tmp_path / "a", "cpu"):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert any(e["name"] == "aten::sum" for e in _events(tmp_path / "a"))
    with trace(tmp_path / "b", CPU):  # a second profiler starts: the first one stopped
        np.ones(3)
    assert _events(tmp_path / "b") is not None
