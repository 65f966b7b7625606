"""Profiling hooks.

The reference's only instrumentation is a final wall-clock print
(reference: src/galileo-sdr.cpp:664-665).  Here:

* `Timer` — lightweight named wall-clock sections and their entry
  counts; the streaming executor (io/stream.py) keeps one per run,
  splitting each block into scenario stepping, host prep/dispatch,
  device wait, and sink time, and those into the spans below (printed
  under -v and by `StreamStats.stage_report`).
* `span(name)` — a nested section of the Timer installed on the running
  thread (`installed(timer)`; the streaming executor installs its Timer
  on each thread it runs).  Each thread keeps a stack of its open spans:
  a span opened inside another is the section `parent/name`
  (`scenario/geometry`), and a parent's section includes its children's
  time.  Every entry counts, so a span that opens only when something
  happens (a code table rebuilt) counts those events.  With no Timer
  installed a span does nothing, so the scenario engine, the host prep
  and the sinks cost the same when called on their own.
  While torch.profiler runs, the innermost open span of a thread holds a
  range named by its path (a `record_function` range, category
  `user_annotation`, opened through the cheaper
  `torch.autograd._record_function_with_args_enter`): opening a
  child ends the parent's range, and closing it opens a new range of the
  parent's.  A thread's ranges never overlap, each stretch of the trace
  is named by the most specific span open then, and a parent's ranges
  add up to its self time.  With no profiler running a span opens no
  range (`torch.autograd._profiler_enabled`, read as it opens).
* `trace(dir, device)` — context manager around `torch.profiler`
  producing a TensorBoard-loadable trace of the run: host activity (the
  span ranges of the threads the profiler sees: the thread that started
  it), and the kernels and copies on the card when `device` is a GPU;
  exposed as the CLI's `--trace-dir` flag (cli.py).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from time import perf_counter

import torch
from torch.autograd import (
    _profiler_enabled,
    _record_function_with_args_enter as _range_enter,
    _record_function_with_args_exit as _range_exit,
)


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
        t0 = perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """One line a section, each parent followed by its spans; shares
        of the top-level sections' sum (a parent includes its children)."""
        total = sum(t for name, t in self.sections.items() if "/" not in name) or 1.0

        def order(name: str) -> list:
            # heaviest first among siblings, children right after their parent
            parts = name.split("/")
            prefixes = ("/".join(parts[: i + 1]) for i in range(len(parts)))
            return [(-self.sections.get(p, 0.0), p) for p in prefixes]

        return "\n".join(
            f"{name:>32}: {self.sections[name]:8.3f} s "
            f"({self.sections[name] / total:5.1%}, {self.counts[name]}x)"
            for name in sorted(self.sections, key=order)
        )


class _Stack(list):
    """A thread's open spans, outermost first, as [path, start, range or
    None], and the sections and counts of the Timer they report to."""

    __slots__ = ("sections", "counts")


class _Thread(threading.local):
    stack: _Stack | None = None  # None: no Timer installed


_THREAD = _Thread()


@contextlib.contextmanager
def installed(timer: Timer):
    """Spans on this thread report to `timer` inside the body, as
    top-level sections; the thread's previous Timer and open spans come
    back after it."""
    th = _THREAD
    saved = th.stack
    th.stack = _Stack()
    th.stack.sections, th.stack.counts = timer.sections, timer.counts
    try:
        yield timer
    finally:
        th.stack = saved


class span:
    """A section of the thread's installed Timer, named by its path in
    the thread's open spans; a range of that path while torch.profiler
    runs and no child of it is open.  Nothing without a Timer.  A span
    keeps no state of its own (the thread's stack does), so one object
    may be entered again, also inside itself.

    The clock is read between ending one range and opening the next, so
    a span's time holds the opening and ending of its own range, as the
    range itself does, and a section's ranges add up to its self time."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> span:
        stack = _THREAD.stack
        if stack is not None:
            path = f"{stack[-1][0]}/{self.name}" if stack else self.name
            if _profiler_enabled():
                if stack and stack[-1][2] is not None:  # the parent's range ends
                    _range_exit(stack[-1][2])
                    stack[-1][2] = None
                t0 = perf_counter()
                stack.append([path, t0, _range_enter(path)])
            else:
                stack.append([path, perf_counter(), None])
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = _THREAD.stack
        if stack is not None:
            path, t0, rng = stack.pop()
            if rng is None:
                dt = perf_counter() - t0
            else:
                _range_exit(rng)
                dt = perf_counter() - t0
                if stack:  # the range passes back to the parent
                    stack[-1][2] = _range_enter(stack[-1][0])
            sections, counts = stack.sections, stack.counts
            sections[path] = sections.get(path, 0.0) + dt
            counts[path] = counts.get(path, 0) + 1
        return False
