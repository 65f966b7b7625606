"""The receiver a traffic file names: static jobs drawn as they were
before the moving receiver came in, the circular orbit's motion, and a
moving cell run end to end on the CPU (jobs of a second, the program's
plain engines), whose check passes the program and fails a trajectory
the program reads one epoch late."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import window
from portbench.harness.jobs import draw_job, epochs_of
from portbench.harness.motion import orbit_ecef
from portbench.harness.spec import read_files
from portbench.reference.hostlayer.constants import GM_EARTH, OMEGA_EARTH, WGS84_RADIUS
from portbench.reference.hostlayer.geodesy import llh2xyz

from test_portbench_run import cpu_line, tiny_cell

# draw_job(traffic, seed, index) before the receiver key and the
# block-first epoch: site, start, checked epochs
STATIC_DRAWS = {
    (0, 0): ((41.36961687321454, -64.6042657247226, 4.0973523936194685),
             (2022, 2, 19, 22, 58, 0), {1, 525}),
    (0, 1): ((43.89738791278134, -58.85723899587548, 80.09080868919722),
             (2022, 2, 19, 23, 4, 9), {95, 2672}),
    (7, 0): ((41.25095466604667, -52.05572398060849, 77.56856902451935),
             (2022, 2, 19, 23, 28, 21), {22, 166}),
    (7, 2): ((37.77970282193581, -61.09693752064902, 93.37384056832592),
             (2022, 2, 19, 23, 16, 41), {68, 2680}),
    (2**31 + 12345, 0): ((39.38976247079804, -60.906906730090505, 9.854022517317507),
                         (2022, 2, 19, 23, 1, 36), {24, 2815}),
    (2147519001, 0): ((41.5876397783001, -60.09261953569057, 20.283930545627793),
                      (2022, 2, 19, 23, 23, 25), {81, 1419}),
    (2147519001, 2): ((41.12507558790819, -66.8444426726024, 99.69842039262555),
                      (2022, 2, 19, 23, 15, 17), {21, 1922}),
    (3000000000, 0): ((39.03694036286146, -64.08169642128362, 18.818901283486056),
                      (2022, 2, 19, 23, 32, 28), {81, 1942}),
}
ORBIT = {"motion": "circular_orbit", "altitude_m": 1336e3, "inclination_deg": 66.0,
         "node_lon_deg": [-90.0, -75.0], "arg_lat_deg": [40.0, 50.0]}
SEED = 2**31 + 4321
WINDOW_S = 10.0  # every block of a moving job falls back to the direct engine: slow on the CPU


@pytest.mark.parametrize("traffic", ["file_b8", "file_b1"])
@pytest.mark.parametrize("static", [None, {"motion": "static"}], ids=["no_key", "static"])
def test_static_jobs_draw_as_before(traffic, static):
    t = read_files("e1_os", traffic)[1]
    if static is not None:
        t["receiver"] = static
    b = t["block_epochs"]
    n = epochs_of(t["job_seconds"])
    for (seed, index), (llh, start, check) in STATIC_DRAWS.items():
        job = draw_job(t, seed, index)
        assert (job.llh, job.start, job.trajectory) == (llh, start, None)
        assert check <= job.check
        extra = job.check - check
        assert len(extra) <= 1 and all(0 < e < n and e % b == 0 for e in extra)


def test_orbit_altitude_speed_and_rows():
    h, rows = 1336e3, 3001
    xyz = orbit_ecef(h, 66.0, -80.0, 45.0, rows)
    r = WGS84_RADIUS + h
    assert xyz.shape == (rows, 3)
    assert np.abs(np.linalg.norm(xyz, axis=1) - r).max() < 1.0
    t = np.arange(rows) * 0.1
    c, s = np.cos(OMEGA_EARTH * t), np.sin(OMEGA_EARTH * t)
    eci = np.stack([c * xyz[:, 0] - s * xyz[:, 1], s * xyz[:, 0] + c * xyz[:, 1], xyz[:, 2]],
                   axis=-1)
    speed = np.linalg.norm(np.diff(eci, axis=0), axis=1) / 0.1
    assert np.abs(speed / np.sqrt(GM_EARTH / r) - 1.0).max() < 1e-3

    # the job's trajectory: lat, lon, height, one row an epoch and two more
    traffic = dict(read_files("e1_os", "file_b8")[1], receiver=ORBIT)
    job = draw_job(traffic, SEED, 0)
    assert job.trajectory.shape == (epochs_of(job.seconds) + 2, 3)
    assert job.llh == tuple(job.trajectory[0])
    back = llh2xyz(np.stack([np.radians(job.trajectory[:, 0]), np.radians(job.trajectory[:, 1]),
                             job.trajectory[:, 2]], axis=-1))
    assert np.abs(np.linalg.norm(back, axis=1) - r).max() < 1.0
    assert job.check == draw_job(traffic, SEED, 0).check  # from the seed alone


def _orbit_cell():
    cell = tiny_cell("e1_os.file_b8", receiver=ORBIT)
    cell.config = dict(cell.config, iono=False)
    return cell


def test_moving_run_is_correct():
    line = cpu_line(_orbit_cell(), seconds=WINDOW_S, seed=SEED)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["checked_epochs"]["value"] >= 1


def test_trajectory_one_epoch_late_is_not_correct(monkeypatch):
    real = window.PositionProvider

    def late(trajectory=None, **kw):
        if trajectory is not None:
            trajectory = np.concatenate([trajectory[:1], trajectory[:-1]])
        return real(trajectory=trajectory, **kw)

    monkeypatch.setattr(window, "PositionProvider", late)
    line = cpu_line(_orbit_cell(), seconds=WINDOW_S, seed=SEED)
    assert line["correct"] is False
    assert line["checks"]["checked_epochs"]["value"] >= 1
