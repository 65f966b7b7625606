"""WGS-84 geodesy and broadcast-ephemeris orbit propagation, vectorized.

Behavioural equivalent of the reference geodesy layer
(reference: src/geodesy.cpp) re-expressed as NumPy array programs: every
function accepts arbitrary leading batch dimensions so the scenario engine
evaluates all (satellite, epoch) pairs in one shot instead of the
reference's scalar per-call style.  float64 throughout — this runs on the
host at 10 Hz cadence; only the sample-rate synthesis runs on the TPU.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    OMEGA_EARTH,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
    WGS84_ECCENTRICITY,
    WGS84_RADIUS,
)

_E2 = WGS84_ECCENTRICITY * WGS84_ECCENTRICITY


def xyz2llh(xyz: np.ndarray) -> np.ndarray:
    """ECEF (..., 3) -> lat/lon/height (..., 3), iterative (geodesy.cpp:7-55)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rho2 = x * x + y * y
    dz = _E2 * z
    np_err = np.seterr(invalid="ignore", divide="ignore")  # origin handled below
    # Fixed-point iteration; the reference loops until |dz - dz_new| < 1e-3 m.
    for _ in range(64):
        zdz = z + dz
        nh = np.sqrt(rho2 + zdz * zdz)
        slat = zdz / nh
        n = WGS84_RADIUS / np.sqrt(1.0 - _E2 * slat * slat)
        dz_new = n * _E2 * slat
        if np.all(np.abs(dz - dz_new) < 1.0e-3):
            dz = dz_new
            break
        dz = dz_new
    zdz = z + dz
    nh = np.sqrt(rho2 + zdz * zdz)
    slat = zdz / nh
    n = WGS84_RADIUS / np.sqrt(1.0 - _E2 * slat * slat)
    lat = np.arctan2(zdz, np.sqrt(rho2))
    lon = np.arctan2(y, x)
    hgt = nh - n
    np.seterr(**np_err)
    out = np.stack([lat, lon, hgt], axis=-1)
    out = np.nan_to_num(out)
    # Degenerate near-origin input (geodesy.cpp:19-27).
    bad = np.linalg.norm(xyz, axis=-1) < 1.0e-3
    if np.any(bad):
        out[bad] = np.array([0.0, 0.0, -WGS84_RADIUS])
    return out


def llh2xyz(llh: np.ndarray) -> np.ndarray:
    """lat/lon/height (..., 3) -> ECEF (..., 3) (geodesy.cpp:61-93)."""
    llh = np.asarray(llh, dtype=np.float64)
    lat, lon, hgt = llh[..., 0], llh[..., 1], llh[..., 2]
    clat, slat = np.cos(lat), np.sin(lat)
    clon, slon = np.cos(lon), np.sin(lon)
    d = WGS84_ECCENTRICITY * slat
    n = WGS84_RADIUS / np.sqrt(1.0 - d * d)
    nph = n + hgt
    t = nph * clat
    return np.stack([t * clon, t * slon, ((1.0 - _E2) * n + hgt) * slat], axis=-1)


def ltcmat(llh: np.ndarray) -> np.ndarray:
    """Local tangent (NEU) rotation matrices (..., 3, 3) (geodesy.cpp:99-120)."""
    llh = np.asarray(llh, dtype=np.float64)
    slat, clat = np.sin(llh[..., 0]), np.cos(llh[..., 0])
    slon, clon = np.sin(llh[..., 1]), np.cos(llh[..., 1])
    zero = np.zeros_like(slat)
    rows = [
        np.stack([-slat * clon, -slat * slon, clat], axis=-1),
        np.stack([-slon, clon, zero], axis=-1),
        np.stack([clat * clon, clat * slon, slat], axis=-1),
    ]
    return np.stack(rows, axis=-2)


def ecef2neu(vec: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotate ECEF difference vectors into NEU frames (geodesy.cpp:127-134)."""
    return np.einsum("...ij,...j->...i", t, np.asarray(vec, dtype=np.float64))


def neu2azel(neu: np.ndarray) -> np.ndarray:
    """NEU (..., 3) -> azimuth/elevation (..., 2) (geodesy.cpp:140-152)."""
    neu = np.asarray(neu, dtype=np.float64)
    az = np.arctan2(neu[..., 1], neu[..., 0])
    az = np.where(az < 0.0, az + 2.0 * np.pi, az)
    ne = np.sqrt(neu[..., 0] ** 2 + neu[..., 1] ** 2)
    el = np.arctan2(neu[..., 2], ne)
    return np.stack([az, el], axis=-1)


def _wrap_week(tk: np.ndarray) -> np.ndarray:
    tk = np.where(tk > SECONDS_IN_HALF_WEEK, tk - SECONDS_IN_WEEK, tk)
    return np.where(tk < -SECONDS_IN_HALF_WEEK, tk + SECONDS_IN_WEEK, tk)


def satpos(eph, t_sec):
    """Satellite position/velocity/clock from broadcast ephemeris.

    Vectorized counterpart of the reference Kepler solver
    (geodesy.cpp:161-273).  `eph` is any object exposing broadcastable
    float64 array attributes (m0, n, ecc, sqrta, A, sq1e2, aop, cuc, cus,
    crc, crs, cic, cis, inc0, idot, omg0, omgkdot, toe_sec, toc_sec, af0,
    af1, af2, bgde5b); `t_sec` is seconds-of-week, broadcast against them.

    Returns (pos, vel, clk): (..., 3), (..., 3), (..., 2).
    The clock includes the relativistic term and subtracts BGD(E1,E5b),
    matching geodesy.cpp:217,268.
    """
    t_sec = np.asarray(t_sec, dtype=np.float64)
    tk = _wrap_week(t_sec - eph.toe_sec)

    mk = eph.m0 + eph.n * tk
    ek = mk.copy() if isinstance(mk, np.ndarray) else np.asarray(mk, dtype=np.float64)
    one_minus_ecose = 1.0 - eph.ecc * np.cos(ek)
    # Newton iteration, fixed count (the reference iterates to 1e-14,
    # capped at 500; a dozen Newton steps reaches float64 round-off).
    for _ in range(12):
        one_minus_ecose = 1.0 - eph.ecc * np.cos(ek)
        ek = ek + (mk - ek + eph.ecc * np.sin(ek)) / one_minus_ecose

    sek, cek = np.sin(ek), np.cos(ek)
    ekdot = eph.n / one_minus_ecose
    relativistic = -4.442807633e-10 * eph.ecc * eph.sqrta * sek

    pk = np.arctan2(eph.sq1e2 * sek, cek - eph.ecc) + eph.aop
    pkdot = eph.sq1e2 * ekdot / one_minus_ecose
    s2pk, c2pk = np.sin(2.0 * pk), np.cos(2.0 * pk)

    uk = pk + eph.cus * s2pk + eph.cuc * c2pk
    suk, cuk = np.sin(uk), np.cos(uk)
    ukdot = pkdot * (1.0 + 2.0 * (eph.cus * c2pk - eph.cuc * s2pk))

    rk = eph.A * one_minus_ecose + eph.crc * c2pk + eph.crs * s2pk
    rkdot = eph.A * eph.ecc * sek * ekdot + 2.0 * pkdot * (
        eph.crs * c2pk - eph.crc * s2pk
    )

    ik = eph.inc0 + eph.idot * tk + eph.cic * c2pk + eph.cis * s2pk
    sik, cik = np.sin(ik), np.cos(ik)
    ikdot = eph.idot + 2.0 * pkdot * (eph.cis * c2pk - eph.cic * s2pk)

    xpk, ypk = rk * cuk, rk * suk
    xpkdot = rkdot * cuk - ypk * ukdot
    ypkdot = rkdot * suk + xpk * ukdot

    ok = eph.omg0 + tk * eph.omgkdot - OMEGA_EARTH * eph.toe_sec
    sok, cok = np.sin(ok), np.cos(ok)

    pos = np.stack(
        [
            xpk * cok - ypk * cik * sok,
            xpk * sok + ypk * cik * cok,
            ypk * sik,
        ],
        axis=-1,
    )
    tmp = ypkdot * cik - ypk * sik * ikdot
    vel = np.stack(
        [
            -eph.omgkdot * pos[..., 1] + xpkdot * cok - tmp * sok,
            eph.omgkdot * pos[..., 0] + xpkdot * sok + tmp * cok,
            ypk * cik * ikdot + ypkdot * sik,
        ],
        axis=-1,
    )

    tkc = _wrap_week(t_sec - eph.toc_sec)
    clk0 = eph.af0 + tkc * (eph.af1 + tkc * eph.af2) + relativistic - eph.bgde5b
    clk1 = eph.af1 + 2.0 * tkc * eph.af2
    clk = np.stack([clk0, clk1], axis=-1)
    return pos, vel, clk


def azel_from(xyz: np.ndarray, target_pos: np.ndarray) -> np.ndarray:
    """Azimuth/elevation of target ECEF positions as seen from `xyz`."""
    llh = xyz2llh(xyz)
    tmat = ltcmat(llh)
    los = np.asarray(target_pos, dtype=np.float64) - xyz
    return neu2azel(ecef2neu(los, tmat))
