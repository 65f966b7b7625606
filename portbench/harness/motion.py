"""Receiver motion of a job: the trajectory a moving receiver follows,
one row an epoch, as the program's `-u` user-motion file gives it
(lat deg, lon deg, height m at 10 Hz, row k at k epochs after the job's
start).

`circular_orbit`: two-body motion on a circle of radius WGS-84 a + h
about the Earth's centre, at the mean motion sqrt(GM / r^3), with the
orbit fixed in an inertial frame that coincides with ECEF at the job's
start; ECEF follows by the Earth's rotation, OMEGA_EARTH t.  The seed
draws the longitude of the ascending node (in ECEF at the job's start)
and the argument of latitude there from the boxes the traffic file
states.  Plain numpy; the constants and `xyz2llh` are the reference
host layer's.
"""

from __future__ import annotations

import numpy as np

from ..reference.hostlayer.constants import GM_EARTH, OMEGA_EARTH, WGS84_RADIUS
from ..reference.hostlayer.geodesy import xyz2llh

EPOCH_S = 0.1


def orbit_ecef(altitude_m: float, inclination_deg: float, node_lon_deg: float,
               arg_lat_deg: float, rows: int) -> np.ndarray:
    """(rows, 3) ECEF metres of the circular orbit at t = 0, 0.1, ... s."""
    r = WGS84_RADIUS + altitude_m
    t = np.arange(rows) * EPOCH_S
    u = np.radians(arg_lat_deg) + np.sqrt(GM_EARTH / r**3) * t
    node, inc = np.radians(node_lon_deg), np.radians(inclination_deg)
    x = r * (np.cos(node) * np.cos(u) - np.sin(node) * np.sin(u) * np.cos(inc))
    y = r * (np.sin(node) * np.cos(u) + np.cos(node) * np.sin(u) * np.cos(inc))
    z = r * np.sin(u) * np.sin(inc)
    rot = OMEGA_EARTH * t  # inertial -> ECEF
    return np.stack([np.cos(rot) * x + np.sin(rot) * y, -np.sin(rot) * x + np.cos(rot) * y, z],
                    axis=-1)


def trajectory(receiver: dict, rng: np.random.Generator, rows: int) -> np.ndarray:
    """(rows, 3) float64 lat deg, lon deg, height m of the motion that
    `receiver` (the traffic file's "receiver") names, drawn from `rng`."""
    if receiver["motion"] != "circular_orbit":
        raise ValueError(f"unknown receiver motion {receiver['motion']!r}")
    node = float(rng.uniform(*receiver["node_lon_deg"]))
    arg_lat = float(rng.uniform(*receiver["arg_lat_deg"]))
    xyz = orbit_ecef(float(receiver["altitude_m"]), float(receiver["inclination_deg"]), node,
                     arg_lat, rows)
    llh = xyz2llh(xyz)
    return np.stack([np.degrees(llh[:, 0]), np.degrees(llh[:, 1]), llh[:, 2]], axis=-1)
