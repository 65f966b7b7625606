"""The traffic of a cell: file-generation jobs drawn from the seed.

Every job is `job_seconds` of signal at a receiver the traffic file's
`receiver` names.  Static (no `receiver`, or `{"motion": "static"}`), the
seed draws each job's site uniformly from the `site` box; moving
(`motion.py`), it draws the motion's parameters on a stream of their own
and the job carries the trajectory, one row an epoch.  Either way the
seed draws the whole-second start time uniformly from the `start` box
(the boxes are chosen so that every job has the same number of
satellites in view, hence the same work), and the epochs whose samples
are checked: one in the job's first `check_head_seconds`,
`check_epochs_per_job - 1` anywhere in the job, and, on a stream of its
own, one that starts a block after the first (`e % block_epochs == 0`,
`e > 0`), where a band-limited stream's filter history comes from the
block before.  The streams of their own leave a static job's draws as
they were before those streams were added.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import motion

EPOCH_S = 0.1


@dataclass(frozen=True)
class Job:
    index: int
    llh: tuple  # (lat deg, lon deg, height m); moving, the trajectory's first row
    start: tuple  # (y, m, d, h, min, s), whole seconds
    seconds: float
    check: frozenset  # 0-based epoch indices whose samples are compared
    # (N, 3) lat deg, lon deg, height m, row k at epoch k (the engine's
    # epoch index; 0 is its start), N = epochs_of(seconds) + 2; None: static
    trajectory: np.ndarray | None = field(default=None, compare=False, repr=False)

    @property
    def start_arg(self) -> str:
        y, mo, d, h, mi, s = self.start
        return f"{y:04d}/{mo:02d}/{d:02d},{h:02d}:{mi:02d}:{s:02d}"


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *stream])


def epochs_of(seconds: float) -> int:
    """Epochs a job of `seconds` emits (the scenario engine's numd - 1)."""
    return max(int(seconds * 10.0 + 0.5) - 1, 0)


def block_first(n: int, block_epochs: int, rng: np.random.Generator) -> set:
    """One epoch of the n that starts a block after the first, or none."""
    blocks = (n - 1) // block_epochs  # blocks that start at an epoch e > 0
    return {block_epochs * int(rng.integers(1, blocks + 1))} if blocks >= 1 else set()


def draw_job(traffic: dict, seed: int, index: int, seconds: float | None = None) -> Job:
    """Job `index` of the run with `seed` (`seconds` overrides the job
    length, as the warm-up does)."""
    rng = _rng(seed, index)
    receiver = traffic.get("receiver", {"motion": "static"})
    static = receiver["motion"] == "static"
    if static:
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
    check.update(block_first(n, traffic["block_epochs"], _rng(seed, index, 2)))
    trajectory = None
    if not static:
        trajectory = motion.trajectory(receiver, _rng(seed, index, 1), n + 2)
        llh = tuple(float(v) for v in trajectory[0])
    return Job(index, llh, (*start["date"], t // 3600, t // 60 % 60, t % 60), seconds,
               frozenset(check), trajectory)


def pick_checked(traffic: dict, seed: int, eligible: list) -> list:
    """At most `check_jobs` of the eligible job indices, drawn from the seed."""
    k = min(traffic["check_jobs"], len(eligible))
    return sorted(_rng(seed, 2**32).choice(eligible, size=k, replace=False).tolist())
