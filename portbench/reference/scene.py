"""The reference scenario of one job: the frozen host layer stepped from
the job's start to the epochs that are checked, with the job's receiver
(static at a site, or a trajectory of one row an epoch) and the nav
file's ionosphere model on or off (the program's `-I`)."""

from __future__ import annotations

import numpy as np

from .hostlayer.gnss_time import DateTime, date2gal
from .hostlayer.models.cboc import E1_CBOC
from .hostlayer.models.e1 import E1_OS
from .hostlayer.rinex import read_rinex_v3
from .hostlayer.scenario import PositionProvider, ScenarioEngine, scenario_start_time

MODELS = {"e1": E1_OS, "cboc": E1_CBOC}


def code_tables(model: str) -> tuple:
    """(data, pilot) code tables of the signal model, (50, 4092 * subdiv)."""
    m = MODELS[model]
    return m.data_codes, m.pilot_codes


def epoch_tables(nav_path: str, llh: tuple, start: tuple, seconds: float, model: str,
                 wanted: set, trajectory: np.ndarray | None = None, iono: bool = True) -> dict:
    """{epoch index: epoch table} of a job for the 0-based epoch indices
    in `wanted`: the receiver static at `llh` (deg, deg, m), or on
    `trajectory` ((N, 3) deg, deg, m, row k at the engine's epoch k) where
    one is given; the scene from `start` (y, m, d, h, min, s) for
    `seconds`; `iono` False disables the ionosphere model."""
    nav = read_rinex_v3(nav_path)
    if not iono:
        nav.iono.enable = False
    g0 = scenario_start_time(nav, date2gal(DateTime(*start[:5], float(start[5]))))
    position = (PositionProvider(llh_deg=np.asarray(llh, np.float64)) if trajectory is None
                else PositionProvider(trajectory=trajectory))
    engine = ScenarioEngine(nav, position, g0, seconds, model=MODELS[model])
    out = {}
    last = max(wanted, default=-1)
    for e, tab in enumerate(engine.epochs()):
        if e in wanted:
            out[e] = tab
        if e >= last:
            break
    return out
