"""Ionospheric delay models: obliquity fallback + NeQuick-G slant TEC.

Behavioural port of the reference ionosphere layer (reference:
src/iono.cpp).  This is host-side float64 code evaluated at 10 Hz per
channel — negligible FLOPs next to the sample-rate synthesis, so clarity
and parity beat vectorization here.

Faithfully reproduced reference quirks (documented because they change
numbers):

* The NeQuick slant-TEC path applies `TEC * 1e-13 * 40.3 / f^2` and then
  divides by c once more before adding to the pseudorange *in meters*
  (iono.cpp:63-65) — making the NeQuick contribution numerically ~0.  The
  obliquity fallback (iono.cpp:9-19) contributes meters.  A
  `physical_units=True` option computes the dimensionally-correct NeQuick
  delay instead (extension, off by default).
* `calcPerigee` receives its invalid-flag by value (iono.cpp:127), so the
  perigee validity check at iono.cpp:715 can never trigger; only the
  `badPos` geometry check (satellite below 2000 km) falls back.
* `calcPerigee` mutates the caller's user latitude to the perigee latitude
  (iono.cpp:191-192); later ray-walk calls observe the mutated value.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .constants import (
    GNSS_PI,
    NEQUICK_MAX_RECURSION,
    NEQUICK_RE_KM,
    NEQUICK_ZENITH0,
    R2D,
    SPEED_OF_LIGHT,
)
from .gnss_time import GalTime, gal2date
from .rinex import IonoUtc

D2R = GNSS_PI / 180.0

_DATA = Path(__file__).parent / "data" / "nequick_tables.npz"


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}



def _exp(x: float) -> float:
    """exp with C-style overflow-to-huge instead of Python OverflowError."""
    if x > 705.0:
        return 1e306
    if x < -745.0:
        return 0.0
    return math.exp(x)

def obliquity_delay(azel_el_rad: float) -> float:
    """Simple obliquity model (iono.cpp:9-19): meters."""
    E = azel_el_rad / GNSS_PI
    F = 1.0 + 16.0 * (0.53 - E) ** 3
    return F * 5.0e-9 * SPEED_OF_LIGHT


# --- NeQuick-G internals ---------------------------------------------


def _interpolate3(z1, z2, z3, z4, x):
    """Third-order interpolation (iono.cpp:203-221)."""
    if abs(2 * x) < 1e-10:
        return z2
    delta = 2 * x - 1
    g1, g2 = z3 + z2, z3 - z2
    g3, g4 = z4 + z1, (z4 - z1) / 3
    a0 = 9 * g1 - g3
    a1 = 9 * g2 - g4
    a2 = g3 - g1
    a3 = g4 - g2
    return (a0 + a1 * delta + a2 * delta**2 + a3 * delta**3) / 16.0


def calc_modip(lat_rad: float, lon_rad: float) -> float:
    """MODIP from the 39x39 grid (iono.cpp:223-259)."""
    lat = R2D * lat_rad
    lon = R2D * lon_rad
    if lat >= 90:
        return 90.0
    if lat <= -90:
        return -90.0
    modip = _tables()["modip"]
    lon_idx = (lon + 180.0) / 10.0
    l = int(math.floor(lon_idx))
    y = lon_idx - l
    if l < 0:
        l += 36
    elif l >= 36:
        l -= 36
    a = (lat + 90.0) / 5.0
    i = int(math.floor(a))
    x = a - i
    zk = [
        _interpolate3(
            modip[i][l + k], modip[i + 1][l + k], modip[i + 2][l + k], modip[i + 3][l + k], x
        )
        for k in range(4)
    ]
    return _interpolate3(zk[0], zk[1], zk[2], zk[3], y)


def calc_az(ai: tuple[float, float, float], mu: float) -> float:
    if ai[0] == 0.0 and ai[1] == 0.0 and ai[2] == 0.0:
        return 63.7
    az = ai[0] + ai[1] * mu + ai[2] * mu * mu
    return min(max(az, 0.0), 400.0)


def _solar_declination_sin(mth: int, ut: int) -> float:
    dy = 30.5 * mth - 15
    t = dy + (18 - ut) / 24
    am = (0.9856 * t - 3.289) * D2R
    al = am + (282.634 + 1.916 * math.sin(am) + 0.020 * math.sin(2 * am)) * D2R
    return 0.39782 * math.sin(al)


def _local_time(lon_rad: float, ut: int) -> float:
    lt = ut + lon_rad * R2D / 15
    if lt < 0:
        lt += 24.0
    elif lt >= 24.0:
        lt -= 24.0
    return lt


def _solar_zenith(phi: float, lt: float, sin_d: float, cos_d: float) -> float:
    cz = math.sin(phi) * sin_d + math.cos(phi) * cos_d * math.cos((12 - lt) * GNSS_PI / 12)
    return R2D * math.atan2(math.sqrt(1 - cz * cz), cz)


def _foE(phi: float, az: float, chi_eff: float, mth: int) -> float:
    # seas is -1 for winter *and* summer months in the reference
    # (iono.cpp:300-305: the May-Aug branch also assigns -1).
    seas = 0 if mth in (3, 4, 9, 10) else -1
    ee = _exp(0.3 * phi * 180.0 / GNSS_PI)
    seasp = seas * (ee - 1) / (ee + 1)
    return math.sqrt(
        (1.112 - 0.019 * seasp) ** 2 * math.sqrt(az) * math.cos(chi_eff * D2R) ** 0.6 + 0.49
    )


def _epst(x, y, z, w):
    e = _exp((w - y) / z)
    return x * e / (1 + e) ** 2


@dataclass
class _NeqInput:
    ai: tuple[float, float, float]
    mth: int
    ut: int
    az: float = 0.0
    az_r: float = 0.0
    af2: np.ndarray | None = None  # (76, 13) Az-interpolated
    am3: np.ndarray | None = None  # (49, 9)
    cf2: np.ndarray | None = None  # (76,) time-of-day Fourier synthesis
    cm3: np.ndarray | None = None  # (49,)


@dataclass
class _Perigee:
    rp: float = 0.0
    latp: float = 0.0
    lonp: float = 0.0
    sinlatp: float = 0.0
    coslatp: float = 0.0
    sinsigp: float = 0.0
    cossigp: float = 0.0
    is_vertical: bool = False


def _calc_perigee(llh1: list[float], llh2: list[float]) -> _Perigee:
    """Ray perigee geometry (iono.cpp:127-195).  Mutates llh1[0] like the
    reference does."""
    p = _Perigee()
    p.is_vertical = abs(llh1[0] - llh2[0]) < 1e-5 and abs(llh1[1] - llh2[1]) < 1e-5
    if p.is_vertical:
        p.latp, p.lonp = llh1[0], llh1[1]
        p.sinlatp, p.coslatp = math.sin(llh1[0]), math.cos(llh1[0])
        return p

    r1 = llh1[2] + NEQUICK_RE_KM
    r2 = llh2[2] + NEQUICK_RE_KM
    cos_delta = math.sin(llh1[0]) * math.sin(llh2[0]) + math.cos(llh1[0]) * math.cos(
        llh2[0]
    ) * math.cos(llh2[1] - llh1[1])
    sin_delta = math.sqrt(1 - cos_delta * cos_delta)
    zeta = math.atan2(sin_delta, cos_delta - r1 / r2)
    p.rp = r1 * math.sin(zeta)

    if abs(abs(llh1[0]) - 90) < 1e-10:
        p.latp = zeta if llh1[0] > 0 else -zeta
        if zeta >= 0:
            p.lonp = llh2[2] + GNSS_PI  # reference reads height here (quirk)
        else:
            p.latp = llh2[2]
    else:
        sin_sigma = math.sin(llh2[1] - llh1[1]) * math.cos(llh2[0]) / sin_delta
        cos_sigma = (math.sin(llh2[0]) - cos_delta * math.sin(llh1[0])) / (
            sin_delta * math.cos(llh1[0])
        )
        delta_p = GNSS_PI / 2 - zeta
        p.sinlatp = math.sin(llh1[0]) * math.cos(delta_p) - math.cos(llh1[0]) * math.sin(
            delta_p
        ) * cos_sigma
        p.coslatp = math.sqrt(1 - p.sinlatp * p.sinlatp)
        p.latp = math.atan2(p.sinlatp, p.coslatp)
        t_sin = -sin_sigma * math.sin(delta_p) / p.coslatp
        t_cos = (math.cos(delta_p) - math.sin(llh1[0]) * p.sinlatp) / (
            math.cos(llh1[0]) * p.coslatp
        )
        p.lonp = math.atan2(t_sin, t_cos) + llh1[1]

    if abs(abs(p.latp) - 90) < 1e-10:
        p.sinsigp = 0.0
        p.cossigp = -1.0 if p.latp > 0 else 1.0
    else:
        cos_psi = p.sinlatp * math.sin(llh2[0]) + p.coslatp * math.cos(llh2[0]) * math.cos(
            llh2[1] - p.lonp
        )
        sin_psi = math.sqrt(1 - cos_psi * cos_psi)
        p.sinsigp = math.cos(llh2[0]) * math.sin(llh2[1] - p.lonp) / sin_psi
        p.cossigp = (math.sin(llh2[0]) - p.sinlatp * cos_psi) / (p.coslatp * sin_psi)

    if not p.is_vertical:
        llh1[0] = math.atan2(p.sinlatp, p.coslatp)  # reference mutates caller
    return p


def _foF2_M3000(mu: float, llh, cf2: np.ndarray, cm3: np.ndarray) -> tuple[float, float]:
    """Legendre-expansion of foF2 / M(3000)F2 (iono.cpp:350-417), with the
    inner coefficient loops vectorized."""
    m_k = np.empty(12)
    m_k[0] = 1.0
    sin_mu = math.sin(mu * D2R)
    for k in range(1, 12):
        m_k[k] = sin_mu**k
    n_arr = np.arange(2, 10)
    p_n = np.cos(llh[0]) ** (n_arr - 1)
    s_n = np.sin((n_arr - 1) * llh[1])
    c_n = np.cos((n_arr - 1) * llh[1])

    foF2 = float(np.dot(cf2[:12], m_k))
    Q = [12, 12, 9, 5, 2, 1, 1, 1, 1]
    K = [-Q[0]]
    for n in range(1, 9):
        K.append(K[n - 1] + 2 * Q[n - 1])
    for n in range(2, 10):
        q = Q[n - 1]
        base = K[n - 1]
        cos_part = cf2[base : base + 2 * q : 2]
        sin_part = cf2[base + 1 : base + 1 + 2 * q : 2]
        foF2 += float(
            np.dot(cos_part * c_n[n - 2] + sin_part * s_n[n - 2], m_k[:q])
        ) * p_n[n - 2]

    M3000 = float(np.dot(cm3[:7], m_k[:7]))
    R = [7, 8, 6, 3, 2, 1, 1]
    H = [-R[0]]
    for n in range(1, 7):
        H.append(H[n - 1] + 2 * R[n - 1])
    for n in range(2, 8):
        r = R[n - 1]
        base = H[n - 1]
        cos_part = cm3[base : base + 2 * r : 2]
        sin_part = cm3[base + 1 : base + 1 + 2 * r : 2]
        M3000 += float(
            np.dot(cos_part * c_n[n - 2] + sin_part * s_n[n - 2], m_k[:r])
        ) * p_n[n - 2]
    return foF2, M3000


def _fourier_cf2(ut: int, af2: np.ndarray, am3: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Time-of-day Fourier synthesis (iono.cpp:419-439), vectorized."""
    T = D2R * (15.0 * ut - 180.0)
    k = np.arange(1, 7)
    cf2 = af2[:, 0] + af2[:, 1::2] @ np.sin(T * k) + af2[:, 2::2] @ np.cos(T * k)
    k4 = np.arange(1, 5)
    cm3 = am3[:, 0] + am3[:, 1::2] @ np.sin(T * k4) + am3[:, 2::2] @ np.cos(T * k4)
    return cf2, cm3


def _elec_dens(data: _NeqInput, s_llh) -> float:
    """Electron density at a ray point (iono.cpp:588-645)."""
    mu = calc_modip(s_llh[0], s_llh[1])
    foF2, M3000F2 = _foF2_M3000(mu, s_llh, data.cf2, data.cm3)
    NmF2 = 0.124 * foF2 * foF2

    sin_d = _solar_declination_sin(data.mth, data.ut)
    cos_d = math.sqrt(1 - sin_d * sin_d)
    lt = _local_time(s_llh[1], data.ut)
    chi = _solar_zenith(s_llh[0], lt, sin_d, cos_d)
    exp_chi = min(_exp(12 * (chi - NEQUICK_ZENITH0)), 1e306)
    chi_eff = (chi + (90 - 0.24 * _exp(20 - 0.2 * chi)) * exp_chi) / (1 + exp_chi)

    foE = _foE(s_llh[0], data.az, chi_eff, data.mth)
    NmE = 0.124 * foE * foE
    hmF2 = _calc_hmF2(foE, foF2, M3000F2)
    B2bot = (0.385 * NmF2) / (
        0.01 * _exp(-3.467 + 0.857 * math.log(foF2 * foF2) + 2.02 * math.log(M3000F2))
    )

    h = s_llh[2]
    if h <= hmF2:
        hmE = 120.0
        hmF1 = (hmF2 + hmE) / 2
        foF1, NmF1 = _foF1_NmF1(foE, foF2)
        BEbot = 5.0
        B1bot = (hmF1 - hmE) / 2
        BEtop = max(B1bot, 7.0)
        B1top = 0.3 * (hmF2 - hmF1)
        A1 = 4 * NmF2
        A2, A3 = _A2_A3(NmE, NmF1, A1, hmF2, hmF1, hmE, BEtop, B1bot, B2bot, foF1)
        return _bottom_side(h, (A1, A2, A3), hmF2, hmF1, hmE, B2bot, B1top, B1bot, BEtop, BEbot)
    k = _shape_k(data.mth, NmF2, hmF2, B2bot, data.az_r)
    return _top_side(h, NmF2, hmF2, _calc_h0(B2bot, k))


def _calc_hmF2(foE, foF2, M3000F2):
    ratio = foF2 / foE
    e = _exp(20 * (ratio - 1.75))
    p = (ratio * e + 1.75) / (e + 1)
    deltaM = -0.012 if foE < 1e-30 else (0.253 / (p - 1.215)) - 0.012
    M2 = M3000F2 * M3000F2
    return (
        (1490 * M3000F2 * math.sqrt((0.0196 * M2 + 1) / (1.2967 * M2 - 1))) / (M3000F2 + deltaM)
    ) - 176


def _foF1_NmF1(foE, foF2):
    foF1 = 1.4 * foE if foE >= 2.0 else 0.0
    if abs(foF1 - foF2) < 1e-6:
        foF1 *= 0.85
    if foF1 < 1e-6:
        foF1 = 0.0
    if foF1 <= 0 and foE > 2:
        NmF1 = 0.124 * (foE + 0.5) ** 2
    else:
        NmF1 = 0.124 * foF1 * foF1
    return foF1, NmF1


def _A2_A3(NmE, NmF1, A1, hmF2, hmF1, hmE, BEtop, B1bot, B2bot, foF1):
    if foF1 < 0.5:
        return 0.0, 4.0 * (NmE - _epst(A1, hmF2, B2bot, hmE))
    A3a = 4.0 * NmE
    A2a = 0.0
    for _ in range(5):
        A2a = 4.0 * (NmF1 - _epst(A1, hmF2, B2bot, hmF1) - _epst(A3a, hmE, BEtop, hmF1))
        e = _exp(A2a - 0.8 * NmF1)
        A2a = (A2a * e + 0.8 * NmF1) / (1 + e)
        A3a = 4.0 * (NmE - _epst(A2a, hmF1, B1bot, hmE) - _epst(A1, hmF2, B2bot, hmE))
    e = _exp(60 * (A3a - 0.005))
    return A2a, (A3a * e + 0.05) / (1 + e)


def _shape_k(mth, NmF2, hmF2, B2bot, az_r):
    if 4 <= mth <= 9:
        ka = 6.705 - 0.014 * az_r - 0.008 * hmF2
    else:
        ka = -7.77 + 0.097 * (hmF2 / B2bot) ** 2 + 0.153 * NmF2
    e = _exp(ka - 2)
    kb = (ka * e + 2) / (1 + e)
    e = _exp(kb - 8)
    return (8 * e + kb) / (1 + e)


def _calc_h0(B2bot, k):
    ha = k * B2bot
    x = (ha - 150) / 100
    v = (0.041163 * x - 0.183981) * x + 1.424472
    return ha / v


def _bottom_side(h, A, hmF2, hmF1, hmE, B2bot, B1top, B1bot, BEtop, BEbot):
    BE = BEbot if h <= hmE else BEtop
    BF1 = B1bot if h <= hmF1 else B1top
    if h < 100.0:
        e = _exp(10 / (1 + abs(100.0 - hmF2)))
        alpha = [(100.0 - hmF2) / B2bot, ((100.0 - hmF1) / BF1) * e, ((100.0 - hmE) / BE) * e]
        s, ds = [0.0] * 3, [0.0] * 3
        denoms = [B2bot, BF1, BE]
        for i in range(3):
            if abs(alpha[i]) <= 25:
                ea = _exp(alpha[i])
                s[i] = A[i] * ea / (1 + ea) ** 2
                ds[i] = ((1 - ea) / (1 + ea)) / denoms[i]
        sum_s = sum(s)
        bc = 1 - 10 * sum(d * v for d, v in zip(ds, s)) / sum_s
        z = (h - 100) / 10
        return sum_s * _exp(1 - bc * z - _exp(-z)) * 1e11
    e = _exp(10.0 / (1.0 + abs(h - hmF2)))
    alpha = [(h - hmF2) / B2bot, ((h - hmF1) / BF1) * e, ((h - hmE) / BE) * e]
    sum_s = 0.0
    for i in range(3):
        if abs(alpha[i]) <= 25:
            ea = _exp(alpha[i])
            sum_s += A[i] * ea / (1 + ea) ** 2
    return sum_s * 1e11


def _top_side(h, NmF2, hmF2, H0):
    g, r = 0.125, 100.0
    dh = h - hmF2
    z = dh / (H0 * (1 + (r * g * dh) / (r * H0 + g * dh)))
    ea = _exp(z)
    if ea > 1e11:
        return 1e11 * 4 * NmF2 / ea
    return 1e11 * 4 * NmF2 * ea / (1 + ea) ** 2


def _ray_point(p: _Perigee, height: float, user_llh, sat_llh):
    """Ray-walk coordinates (iono.cpp:71-105)."""
    if p.is_vertical:
        return [user_llh[0], user_llh[1], sat_llh[2]]
    radius = math.sqrt(height * height + p.rp * p.rp)
    h = radius - NEQUICK_RE_KM
    tan_d = height / p.rp
    cos_d = 1.0 / math.sqrt(1.0 + tan_d * tan_d)
    sin_d = tan_d * cos_d
    sin_lat = math.sin(user_llh[0]) * cos_d + math.cos(user_llh[0]) * sin_d * p.cossigp
    cos_lat = math.sqrt(1.0 - sin_lat * sin_lat)
    lat = math.atan2(sin_lat, cos_lat)
    sin_dl = sin_d * p.sinsigp * math.cos(user_llh[0])
    cos_dl = cos_d - math.sin(user_llh[0]) * sin_lat
    lon = math.atan2(sin_dl, cos_dl) + p.lonp
    return [lat, lon, h]


def _density_at(s, p, data, user_llh, sat_llh):
    llh = _ray_point(p, s, user_llh, sat_llh)
    if p.is_vertical:
        llh[2] = s
    else:
        llh[2] = math.sqrt(s * s + p.rp * p.rp) - NEQUICK_RE_KM
    return _elec_dens(data, llh)


def _kronrod(h1, h2, p, data, tol, level, user_llh, sat_llh) -> float:
    """Adaptive Gauss-Kronrod K15/G7 (iono.cpp:656-706)."""
    t = _tables()
    xi, wi, wig = t["kronrod_xi"], t["kronrod_wi"], t["gauss_wg"]
    mid, half = (h1 + h2) / 2.0, (h2 - h1) / 2.0
    k15 = g7 = 0.0
    gi = 0
    for i in range(15):
        n = _density_at(mid + half * xi[i], p, data, user_llh, sat_llh)
        k15 += n * wi[i]
        if i % 2 == 1:
            g7 += n * wig[gi]
            gi += 1
    k15 *= half
    g7 *= half
    ok = abs((k15 - g7) / k15) <= tol if k15 != 0 else True
    if ok or abs(k15 - g7) <= tol or level[0] >= NEQUICK_MAX_RECURSION:
        return k15
    level[0] += 1
    r = _kronrod(h1, h1 + half, p, data, tol, level, user_llh, sat_llh)
    r += _kronrod(h1 + half, h2, p, data, tol, level, user_llh, sat_llh)
    level[0] -= 1
    return r


def nequick_tec(user_llh, sat_llh, data: _NeqInput) -> tuple[float, bool]:
    """Slant TEC along user->satellite ray (iono.cpp:708-763).

    llh heights in km.  Returns (TEC * 1e-13 as the reference scales it,
    invalid flag)."""
    user_llh = list(user_llh)
    sat_llh = list(sat_llh)
    p = _calc_perigee(user_llh, sat_llh)

    if sat_llh[2] <= 2000.0:  # badPos (iono.cpp:727)
        return 0.0, True

    r1 = user_llh[2] + NEQUICK_RE_KM
    r2 = sat_llh[2] + NEQUICK_RE_KM
    s1 = math.sqrt(max(r1 * r1 - p.rp * p.rp, 0.0))
    s2 = math.sqrt(max(r2 * r2 - p.rp * p.rp, 0.0))
    level = [0]

    if user_llh[2] >= 2000.0:
        if p.is_vertical:
            s1, s2 = user_llh[2], sat_llh[2]
        tec = _kronrod(s1, s2, p, data, 0.01, level, user_llh, sat_llh)
    elif user_llh[2] >= 1000.0:
        if p.is_vertical:
            s1, s2, sb = user_llh[2], sat_llh[2], 2000.0
        else:
            sb = math.sqrt(70076989.44 - p.rp * p.rp)
        tec = _kronrod(s1, sb, p, data, 0.01, level, user_llh, sat_llh)
        tec += _kronrod(sb, s2, p, data, 0.01, level, user_llh, sat_llh)
    else:
        if p.is_vertical:
            s1, s2, sa, sb = user_llh[2], sat_llh[2], 1000.0, 2000.0
        else:
            sa = math.sqrt(54334589.44 - p.rp * p.rp)
            sb = math.sqrt(70076989.44 - p.rp * p.rp)
        tec = _kronrod(s1, sa, p, data, 0.001, level, user_llh, sat_llh)
        level = [0]
        tec += _kronrod(sa, sb, p, data, 0.01, level, user_llh, sat_llh)
        level = [0]
        tec += _kronrod(sb, s2, p, data, 0.01, level, user_llh, sat_llh)

    return tec * 1e-13, False


def ionospheric_delay(
    iono: IonoUtc,
    g: GalTime,
    user_llh,
    sat_llh,
    azel,
    freq: float,
    physical_units: bool = False,
    quirk_fast_path: bool = True,
) -> float:
    """Slant delay added to the pseudorange [m] (iono.cpp:30-69)."""
    if not iono.enable:
        return 0.0
    if not iono.vflg:
        return obliquity_delay(azel[1])

    if not physical_units and quirk_fast_path and sat_llh[2] > 2000e3:
        # Reference-parity shortcut: the reference's NeQuick path divides
        # the range error by c a second time (iono.cpp:64-65), yielding
        # ~1e-25 m for any realistic TEC.  Adding that to a ~2e7 m
        # pseudorange in float64 is exactly a no-op (2e7 + 1e-25 == 2e7),
        # so skipping the 40 ms integration is bit-identical.  The geometry
        # guard mirrors the badPos check (iono.cpp:727): satellites below
        # 2000 km would fall back to the obliquity model instead.
        return 0.0

    t = _tables()
    date = gal2date(g)
    data = _NeqInput(ai=(iono.ai0, iono.ai1, iono.ai2), mth=date.m, ut=date.hh)
    f2 = t["f2"][date.m - 1]
    fm3 = t["fm3"][date.m - 1]
    user = [user_llh[0], user_llh[1], user_llh[2] / 1000.0]
    sat = [sat_llh[0], sat_llh[1], sat_llh[2] / 1000.0]
    data.az = calc_az(data.ai, calc_modip(user[0], user[1]))
    data.az_r = math.sqrt(167273 + (data.az - 63.7) * 1123.6) - 408.99
    azr = data.az_r / 100.0
    data.af2 = f2[0] * (1 - azr) + f2[1] * azr
    data.am3 = fm3[0] * (1 - azr) + fm3[1] * azr
    data.cf2, data.cm3 = _fourier_cf2(data.ut, data.af2, data.am3)

    tec, invalid = nequick_tec(user, sat, data)
    if invalid:
        return obliquity_delay(azel[1])
    if physical_units:
        # TEC integral is in (1e11 el/m^3)*km; convert to el/m^2 and apply
        # the standard 40.3 TEC / f^2 group delay in meters.
        tec_el_m2 = tec * 1e13 * 1e3
        return 40.3 * tec_el_m2 / (freq * freq)
    # Reference unit quirk: treats the scaled TEC as el/m^2 and divides by c
    # once more (iono.cpp:64-65) -> numerically negligible delay.
    range_error = tec * 40.3 / (freq * freq)
    return range_error / SPEED_OF_LIGHT
