"""The comparison that decides `correct`.

Once the window has closed, the epochs the tee kept in a sample of the
jobs (drawn from the seed) are worked out again by the plain reference
(portbench/reference: the frozen host layer from the nav file, then the
float64 sample sums), and each is compared with what the sink received:

* `dense_pct`: the share (%) of 50 us stretches (130 samples, 260 int16
  values) of the epoch whose median |difference| exceeds 1 LSB, in the
  worst checked epoch.  The program computes its phases in float32, so a
  few samples at chip edges take the chip on the other side and a
  truncation may land one LSB off; those are sparse and leave every
  stretch's median at 0 or 1.  A lower precision, or a symbol, chip or
  block that is wrong, moves whole stretches.
* `off1_pct`: the share (%) of int16 values more than 1 LSB off, in the
  worst checked epoch: it also sees sparse faults.  It is compared where
  the configuration gives it a limit; band-limited, the filter spreads
  each chip-edge sample over 33 outputs, and it separates the program
  from the control too narrowly to be compared.
* `max_abs`: the largest |difference| of an int16 value, in the worst
  checked epoch; compared where the configuration gives a limit.
  Band-limited, it sees the filter's history: one reset to zero at a
  block's edge moves that block's first outputs by far more than the
  program's float32 phases can (each job checks an epoch that starts a
  block, jobs.py), but too few of them to move a 50 us median.
* `missing_epochs`: epochs a job that ran to its end did not hand to the
  sink (or handed over beyond its end), summed over those jobs; exact.
* `checked_epochs`: epochs compared; a run must check at least one.

The limits are the configuration's (`checks`); PERF.md gives the readings
they were set from.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import scene, synth
from .jobs import pick_checked

STRETCH = 260  # int16 values a stretch: 130 samples, 50 us


@dataclass
class CheckResult:
    readings: dict = field(default_factory=dict)  # name -> value
    limits: dict = field(default_factory=dict)  # name -> limit (compared numbers only)
    failed_jobs: set = field(default_factory=set)  # indices of jobs that failed a check
    per_epoch: list = field(default_factory=list)  # (job, epoch, off1 %, dense %, max_abs)

    @property
    def passed(self) -> bool:
        return all(self.readings[k] <= v for k, v in self.limits.items()) and \
            self.readings["checked_epochs"] >= 1


def epoch_numbers(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(off1 %, dense %, max_abs) of one epoch's interleaved int16 values."""
    if got.shape != ref.shape:
        return 100.0, 100.0, 65535
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    off1 = float((d > 1).mean()) * 100.0
    n = d.size // STRETCH * STRETCH
    dense = float((np.median(d[:n].reshape(-1, STRETCH), axis=1) > 1).mean()) * 100.0
    return off1, dense, int(d.max())


def reference_epochs(job, epochs, config: dict, nav_path: str, device,
                     mix_dtype=torch.float64, filter_tf32: bool = False,
                     reset_every: int = 0) -> dict:
    """{epoch: int16 values} of the plain reference for a job's epochs,
    with the job's receiver (its trajectory, or its site) and the
    configuration's `iono` (default on).  `mix_dtype` and `filter_tf32`:
    the control's precisions; `reset_every` B > 0: the control's history
    fault, the filter's history zero at every epoch e % B == 0."""
    bl = config["bandlimit"]
    wanted = set(epochs) | ({e - 1 for e in epochs if e > 0} if bl else set())
    tabs = scene.epoch_tables(nav_path, job.llh, job.start, job.seconds, config["model"], wanted,
                              job.trajectory, config.get("iono", True))
    data, pilot = scene.code_tables(config["model"])
    out = {}
    for e in epochs:
        if bl:
            prev = None if reset_every and e % reset_every == 0 else tabs.get(e - 1)
            out[e] = synth.bandlimited_epoch(tabs[e], prev, data, pilot, device, mix_dtype,
                                             filter_tf32)
        else:
            out[e] = synth.pointwise_epoch(tabs[e], data, pilot, device, mix_dtype)
    return out


def check_run(results: list, config: dict, traffic: dict, seed: int, nav_path: str,
              device) -> CheckResult:
    res = CheckResult()
    missing = 0
    for r in results:
        if r.finished and r.epochs != r.expected:
            missing += abs(r.expected - r.epochs)
            res.failed_jobs.add(r.job.index)
        elif r.epochs > r.expected:
            missing += r.epochs - r.expected
            res.failed_jobs.add(r.job.index)
    limits = config["checks"]
    worst = {"off1_pct": 0.0, "dense_pct": 0.0, "max_abs": 0}
    checked = 0
    eligible = [r.job.index for r in results if r.kept]
    for idx in pick_checked(traffic, seed, eligible):
        r = results[idx]
        refs = reference_epochs(r.job, sorted(r.kept), config, nav_path, device)
        for e in sorted(r.kept):
            numbers = epoch_numbers(r.kept[e], refs[e])
            res.per_epoch.append((idx, e, *numbers))
            checked += 1
            for k, v in zip(worst, numbers):
                worst[k] = max(worst[k], v)
                if k in limits and v > limits[k]:
                    res.failed_jobs.add(idx)
    res.readings = {**worst, "missing_epochs": missing, "checked_epochs": checked}
    res.limits = {k: limits[k] for k in ("dense_pct", "off1_pct", "max_abs", "missing_epochs")
                  if k in limits}
    return res
