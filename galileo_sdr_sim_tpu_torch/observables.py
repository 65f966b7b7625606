"""Pseudorange / Doppler observables engine.

Vectorized counterpart of the reference observables layer
(reference: src/gal-sig.cpp:242-347).  `compute_range` evaluates the full
satpos -> light-time -> Earth-rotation -> az/el -> iono chain for arrays of
(satellite, epoch) pairs in one shot; `code_phase_state` converts a range
pair into the NCO state the synthesizer consumes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import geodesy
from .constants import (
    CA_SEQ_LEN_E1,
    CARR_FREQ,
    CARR_TO_CODE_E1,
    CODE_FREQ_E1,
    LAMBDA_E1,
    N_SYM_PAGE,
    OMEGA_EARTH,
    SPEED_OF_LIGHT,
)
from .gnss_time import GalTime
from .iono import ionospheric_delay
from .rinex import IonoUtc


_user_cache: dict = {}


@dataclass
class RangeSet:
    """Vectorized range_t (structures.h:129-137): arrays over a batch."""

    range: np.ndarray  # pseudorange incl. clock + iono [m]
    d: np.ndarray  # geometric distance [m]
    azel: np.ndarray  # (..., 2) az/el [rad]
    iono_delay: np.ndarray
    t_sec: np.ndarray  # receive time (seconds of week) of each sample


def compute_range(
    eph, iono: IonoUtc, week: int, t_sec: np.ndarray, xyz: np.ndarray
) -> RangeSet:
    """Pseudorange + az/el for broadcastable (eph batch, t_sec, xyz).

    Follows gal-sig.cpp:242-301: one light-time back-extrapolation step
    using the satellite velocity, Earth-rotation correction, clock applied
    as -c*clk, NeQuick/obliquity iono added in meters.
    """
    t_sec = np.asarray(t_sec, dtype=np.float64)
    xyz = np.asarray(xyz, dtype=np.float64)
    pos, vel, clk = geodesy.satpos(eph, t_sec)

    los = pos - xyz
    tau = np.linalg.norm(los, axis=-1) / SPEED_OF_LIGHT
    pos = pos - vel * tau[..., None]

    xrot = pos[..., 0] + pos[..., 1] * OMEGA_EARTH * tau
    yrot = pos[..., 1] - pos[..., 0] * OMEGA_EARTH * tau
    pos = np.stack([xrot, yrot, pos[..., 2]], axis=-1)

    los = pos - xyz
    dist = np.linalg.norm(los, axis=-1)
    prange = dist - SPEED_OF_LIGHT * clk[..., 0]

    # receiver-side geodesy depends only on xyz (static across epochs in
    # fixed-position scenarios) — single-entry cache, keyed on the shape
    # too: a one-epoch chunk's (1, 1, 3) position has the bytes of the
    # (3,) one that channel allocation passes, and not its shapes
    ukey = (xyz.shape, xyz.tobytes())
    if _user_cache.get("key") == ukey:
        user_llh, tmat = _user_cache["val"]
    else:
        user_llh = geodesy.xyz2llh(xyz)
        tmat = geodesy.ltcmat(user_llh)
        _user_cache.update(key=ukey, val=(user_llh, tmat))
    sat_llh = geodesy.xyz2llh(pos)
    neu = geodesy.ecef2neu(los, tmat)
    azel = geodesy.neu2azel(neu)

    # Iono delay is scalar host code; evaluate per element.
    flat_shape = dist.shape
    iono_delay = np.zeros(flat_shape, dtype=np.float64)
    it = np.ndindex(*flat_shape)
    u_llh = np.broadcast_to(user_llh, flat_shape + (3,))
    s_llh = np.broadcast_to(sat_llh, flat_shape + (3,))
    t_b = np.broadcast_to(t_sec, flat_shape)
    for idx in it:
        iono_delay[idx] = ionospheric_delay(
            iono,
            GalTime(week, float(t_b[idx])),
            u_llh[idx],
            s_llh[idx],
            azel[idx],
            CARR_FREQ,
        )
    prange = prange + iono_delay

    return RangeSet(
        range=prange,
        d=dist,
        azel=azel,
        iono_delay=iono_delay,
        t_sec=np.broadcast_to(t_sec, flat_shape).copy(),
    )


@dataclass
class NcoState:
    """Per-(epoch, channel) synthesis seed (channel_t working fields)."""

    f_carr: np.ndarray  # carrier Doppler [Hz] (= -rho_rate / lambda)
    f_code: np.ndarray  # chip rate incl. Doppler [chips/s]
    code_phase: np.ndarray  # initial code phase [chips, 0..4092)
    ibit: np.ndarray  # symbol index in page [0..500)
    ipage: np.ndarray  # half-page counter [0..360)


def code_phase_state(
    range0: np.ndarray, range1: np.ndarray, dt: float, grx_sec: np.ndarray
) -> NcoState:
    """NCO state from two pseudoranges dt apart (gal-sig.cpp:308-347).

    Reproduces the reference exactly, including the `(ibit + 250) % 500`
    half-page offset and `ipage % 360`.
    """
    range0 = np.asarray(range0, dtype=np.float64)
    range1 = np.asarray(range1, dtype=np.float64)
    grx_sec = np.asarray(grx_sec, dtype=np.float64)

    rhorate = (range1 - range0) / dt
    f_carr = -rhorate / LAMBDA_E1
    f_code = CODE_FREQ_E1 + f_carr * CARR_TO_CODE_E1

    ms = (grx_sec - range1 / SPEED_OF_LIGHT) * 1000.0
    ipage = (ms / 2000.0).astype(np.int64)
    ms = ms - ipage * 2000
    ibit = (ms / 4).astype(np.uint64).astype(np.int64)  # C (unsigned int) cast
    ms = ms - ibit * 4
    code_phase = ms / 4 * CA_SEQ_LEN_E1
    ibit = (ibit + N_SYM_PAGE // 2) % N_SYM_PAGE

    return NcoState(
        f_carr=f_carr,
        f_code=f_code,
        code_phase=code_phase,
        ibit=ibit,
        ipage=ipage % 360,
    )


def initial_carrier_phase(r_ref: np.ndarray, r_xyz: np.ndarray) -> np.ndarray:
    """Carrier-phase init from ranges at ECEF origin and receiver
    (channel.cpp:89-99): frac((2*r_ref - r_xyz) / lambda_L1)."""
    from .constants import LAMBDA_L1

    phase = (2.0 * np.asarray(r_ref) - np.asarray(r_xyz)) / LAMBDA_L1
    return phase - np.floor(phase)
