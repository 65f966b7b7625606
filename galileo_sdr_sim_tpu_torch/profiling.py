"""Profiling hooks.

The reference's only instrumentation is a final wall-clock print
(reference: src/galileo-sdr.cpp:664-665).  Here:

* `trace(dir, device)` — context manager around `torch.profiler`
  producing a TensorBoard-loadable trace of the run: host activity, and
  the kernels and copies on the card when `device` is a GPU; exposed as
  the CLI's `--trace-dir` flag (cli.py).  The streaming executor names
  its stages in it with `record_function` ranges of its Timer sections.
* `Timer` — lightweight named wall-clock sections; the streaming
  executor (io/stream.py) keeps one per run, splitting each block into
  host prep/dispatch, device wait, and sink time (printed under -v and
  by `StreamStats.stage_report`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Profile the body with torch.profiler (CPU activity, plus CUDA
    activity on a GPU `device`) and write its trace to `log_dir` when
    the body ends, however it ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
    prof.start()
    try:
        yield
    finally:
        prof.stop()


@dataclass
class Timer:
    sections: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [
            f"{name:>24}: {t:8.3f} s ({t / total:5.1%}, {self.counts[name]}x)"
            for name, t in sorted(
                self.sections.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines)
