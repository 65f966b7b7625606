"""Checkpoint / resume of scenario state.

The reference has no resume capability (SURVEY §5: resume = rerun).  Here
the complete synthesis state at an epoch boundary is an explicit, small
structure — receiver time, channel bank (PRN, carrier phase, pseudorange,
current page symbols, ephemeris indices) — so any run can be snapshotted
per block and continued bit-identically: the next epoch's code phase and
symbol counters are re-derived analytically from the pseudorange exactly
as in normal operation, and carrier phase is part of the snapshot.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .constants import MAX_CHAN, MAX_SAT
from .gnss_time import GalTime
from .scenario import EpochStateTable, ScenarioEngine

_TAB_FIELDS = ("prn", "f_carr", "f_code", "code_phase0", "carr_phase0",
               "ibit0", "sym_win", "pilot_win", "gain", "azel")


def save_state(
    engine: ScenarioEngine,
    path: str | Path,
    drained_iumd: int | None = None,
) -> None:
    """Snapshot engine state after the most recent *yielded* epoch — or,
    with `drained_iumd`, after the last epoch actually DRAINED to the
    sink.

    The chunked scenario fast-path commits engine state a whole chunk
    ahead of the epochs actually consumed, so the not-yet-yielded lookahead
    tabs are serialized too — resume is exact even mid-chunk.

    A pipelined consumer (io/stream.py) additionally holds yielded-but-
    not-drained blocks in flight; `drained_iumd` rewinds the snapshot to
    the sink's position by re-buffering the in-flight tabs from the
    engine's replay ring (`engine._replay_keep` must cover the pipeline
    depth), so a crash+resume replays them instead of skipping their
    samples."""
    chans = engine.bank.channels
    pending = list(engine._pending)
    next_iumd = engine._next_iumd
    if drained_iumd is not None and drained_iumd < next_iumd - 1:
        need = list(range(drained_iumd + 1, next_iumd))
        have = {i: t for i, t in engine._replay}
        missing = [i for i in need if i not in have]
        if missing:
            raise ValueError(
                f"cannot rewind snapshot to drained epoch {drained_iumd}: "
                f"replay ring is missing epochs {missing[:4]}... — raise "
                "engine._replay_keep to cover the pipeline depth"
            )
        pending = [have[i] for i in need] + pending
        next_iumd = drained_iumd + 1
    meta = {
        "next_iumd": next_iumd,
        "pending_n": len(pending),
        "grx_week": engine.grx.week,
        "grx_sec": engine.grx.sec,
        "g0_week": engine.g0.week,
        "g0_sec": engine.g0.sec,
        "numd": engine.numd,
        "tow_applied": engine._tow_applied,
        "current_eph": engine.current_eph,
        "allocated": {str(k): v for k, v in engine.bank.allocated.items()},
        "channels": [
            {
                "prn": c.prn,
                "carr_phase": c.carr_phase,
                "f_carr": c.f_carr,
                "f_code": c.f_code,
                "code_phase": c.code_phase,
                "ibit": c.ibit,
                "ipage": c.ipage,
                "rho0_range": c.rho0_range,
                "azel": list(c.azel),
                "eph_index": c.eph_index,
            }
            for c in chans
        ],
    }
    pages = np.stack(
        [
            c.page if c.page is not None else np.zeros(500, np.uint8)
            for c in chans
        ]
    )
    arrays = {"pages": pages}
    if pending:
        arrays["pending_grx_sec"] = np.array([t.grx_sec for t in pending])
        for f in _TAB_FIELDS:
            arrays[f"pending_{f}"] = np.stack(
                [getattr(t, f) for t in pending]
            )
    path = Path(path)
    np.savez_compressed(path.with_suffix(".npz"), **arrays)
    path.with_suffix(".json").write_text(json.dumps(meta))


def load_state(engine: ScenarioEngine, path: str | Path) -> int:
    """Restore a snapshot into a freshly-constructed engine (same nav/
    position/duration).  Returns the epoch index to continue from."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as z:
        pages = z["pages"]
        pending: list[EpochStateTable] = []
        for k in range(int(meta.get("pending_n", 0))):
            pending.append(
                EpochStateTable(
                    grx_sec=float(z["pending_grx_sec"][k]),
                    **{f: z[f"pending_{f}"][k].copy() for f in _TAB_FIELDS},
                )
            )

    engine.grx = GalTime(meta["grx_week"], meta["grx_sec"])
    engine.g0 = GalTime(meta["g0_week"], meta["g0_sec"])
    engine.numd = meta["numd"]
    engine._tow_applied = bool(meta.get("tow_applied", False))
    engine.current_eph = list(meta["current_eph"])
    engine.bank.allocated = {int(k): v for k, v in meta["allocated"].items()}
    for i, (c, m) in enumerate(zip(engine.bank.channels, meta["channels"])):
        c.prn = m["prn"]
        c.carr_phase = m["carr_phase"]
        c.f_carr = m["f_carr"]
        c.f_code = m["f_code"]
        c.code_phase = m["code_phase"]
        c.ibit = m["ibit"]
        c.ipage = m["ipage"]
        c.rho0_range = m["rho0_range"]
        c.azel = tuple(m["azel"])
        c.eph_index = m["eph_index"]
        c.page = pages[i].copy()
    if "next_iumd" in meta:
        done = int(meta["next_iumd"]) - 1
    else:  # legacy snapshot: (grx - g0)/dt - 2 (two pre-loop increments)
        from .constants import EPOCH_DT

        done = int(round((engine.grx - engine.g0) / EPOCH_DT)) - 2
    done = max(done, 0)
    engine._pending = pending
    engine._pending_base = done + 1
    engine._next_iumd = done + 1
    return done
