"""Profiling hooks.

The reference's only instrumentation is a final wall-clock print
(reference: src/galileo-sdr.cpp:664-665).  Here:

* `Timer` — lightweight named wall-clock sections; the streaming
  executor (io/stream.py) keeps one per run, splitting each block into
  host prep/dispatch, device wait, and sink time (printed under -v and
  by `StreamStats.stage_report`).

The device trace of the run (the CLI's `--trace-dir`) is not ported yet.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


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
