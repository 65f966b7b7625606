"""The traffic of a cell: file-generation jobs drawn from the seed.

Every job is `job_seconds` of signal at a static receiver.  The seed
draws each job's site and whole-second start time uniformly from the
boxes the traffic file states (chosen so that every job has the same
number of satellites in view, hence the same work), and the epochs whose
samples are checked: one in the job's first `check_head_seconds` and
`check_epochs_per_job - 1` anywhere in the job.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EPOCH_S = 0.1


@dataclass(frozen=True)
class Job:
    index: int
    llh: tuple  # (lat deg, lon deg, height m)
    start: tuple  # (y, m, d, h, min, s), whole seconds
    seconds: float
    check: frozenset  # 0-based epoch indices whose samples are compared

    @property
    def start_arg(self) -> str:
        y, mo, d, h, mi, s = self.start
        return f"{y:04d}/{mo:02d}/{d:02d},{h:02d}:{mi:02d}:{s:02d}"


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *stream])


def epochs_of(seconds: float) -> int:
    """Epochs a job of `seconds` emits (the scenario engine's numd - 1)."""
    return max(int(seconds * 10.0 + 0.5) - 1, 0)


def draw_job(traffic: dict, seed: int, index: int, seconds: float | None = None) -> Job:
    """Job `index` of the run with `seed` (`seconds` overrides the job
    length, as the warm-up does)."""
    rng = _rng(seed, index)
    site = traffic["site"]
    llh = tuple(float(rng.uniform(*site[k])) for k in ("lat_deg", "lon_deg", "height_m"))
    start = traffic["start"]
    first, last = (h * 3600 + m * 60 + s for h, m, s in (start["first"], start["last"]))
    t = int(rng.integers(first, last + 1))
    seconds = float(traffic["job_seconds"] if seconds is None else seconds)
    n = epochs_of(seconds)
    head = min(n, max(1, int(traffic["check_head_seconds"] / EPOCH_S)))
    check = {int(rng.integers(0, head))}
    check.update(int(e) for e in rng.integers(0, n, traffic["check_epochs_per_job"] - 1))
    return Job(index, llh, (*start["date"], t // 3600, t // 60 % 60, t % 60), seconds,
               frozenset(check))


def pick_checked(traffic: dict, seed: int, eligible: list) -> list:
    """At most `check_jobs` of the eligible job indices, drawn from the seed."""
    k = min(traffic["check_jobs"], len(eligible))
    return sorted(_rng(seed, 2**32).choice(eligible, size=k, replace=False).tolist())
