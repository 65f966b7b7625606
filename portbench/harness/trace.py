"""The traced run: torch.profiler over the window (CPU and CUDA activity),
its Chrome trace written under TMPDIR, read back and deleted, and reduced
to what the per-layer readers take.

Device time is that of the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events inside the range `portbench.window`.  The kp pair is found by its
kernels' names (`kp_planes_kernel`, the prologue, whose grid is
(13, B, C), and `synth_kp_v5_kernel<CBOC, GAIN, F32>`); the band-limit
filter's convolution by the kernels launched from inside an
`aten::conv1d` operator.  An idle stretch of the device is named by the
host range (the stream's stage ranges and the harness's own) open while
it lasted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "portbench.window"
PROLOGUE, MAIN = "kp_planes_kernel", "synth_kp_v5_kernel"
CONV_OP = "aten::conv1d"


@dataclass
class KpCall:
    B: int
    C: int
    cboc: bool
    gain: bool
    seconds: float  # the prologue's and the main kernel's device time


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    op_seconds: dict = field(default_factory=dict)  # device op name -> seconds
    kp_calls: list = field(default_factory=list)
    conv_calls: int = 0
    conv_seconds: float = 0.0
    idle_by_range: dict = field(default_factory=dict)  # host range -> idle seconds


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(prof) -> TraceSummary:
    """Export the finished profile to a temporary file, reduce it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _template_flags(name: str) -> tuple:
    """`synth_kp_v5_kernel<true, false, false>` -> (cboc, gain)."""
    args = name.split(MAIN + "<", 1)[1].split(">", 1)[0].split(",")
    return tuple(a.strip() in ("true", "1") for a in args[:2])


def reduce_events(events: list) -> TraceSummary:
    """Chrome trace events (times in microseconds) -> TraceSummary."""
    win = [e for e in events if e.get("name") == WINDOW_RANGE and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        return TraceSummary()
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    out = TraceSummary(window_s=(w1 - w0) * 1e-6)

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    out.busy_s = sum(b - a for a, b in busy) * 1e-6
    ops = defaultdict(float)
    for e in dev:
        ops[e["name"]] += e["dur"] * 1e-6
    out.op_seconds = dict(ops)

    # the kp pairs, in launch (correlation) order
    kernels = sorted((e for e in dev if e["cat"] == "kernel"),
                     key=lambda e: e.get("args", {}).get("correlation", 0))
    pending = None
    for e in kernels:
        if PROLOGUE in e["name"]:
            pending = e
        elif MAIN in e["name"] and pending is not None:
            _, B, C = pending["args"]["grid"]
            cboc, gain = _template_flags(e["name"])
            out.kp_calls.append(KpCall(B, C, cboc, gain, (pending["dur"] + e["dur"]) * 1e-6))
            pending = None

    # the filter's convolution: kernels launched inside aten::conv1d
    convs = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("name") == CONV_OP and w0 <= e["ts"] <= w1:
            convs[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
            out.conv_calls += 1
    if convs:
        for tid in convs:
            convs[tid].sort()
        launches = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        for e in kernels:
            tid, ts = launches.get(e.get("args", {}).get("correlation"), (None, None))
            spans = convs.get(tid, [])
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if spans and i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                out.conv_seconds += e["dur"] * 1e-6

    # idle stretches inside the window, named by the host ranges they overlap
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                  and e.get("name") != WINDOW_RANGE and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle = defaultdict(float)
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        # host ranges do not overlap one another on the stream's thread
        while i < len(host) and host[i][0] < g1:
            a, b, name = host[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle[name] += part * 1e-6
                covered += part
            i += 1
        idle["between ranges"] += (g1 - g0 - covered) * 1e-6
    out.idle_by_range = dict(idle)
    return out
