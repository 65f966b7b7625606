"""RINEX v3 Galileo navigation-file parser.

Behavioural port of the reference parser (reference: src/rinex.cpp):
fixed-column fields, D->E exponent fix-up, E1-B data-source filter
(flag == 517), GAUT/IONOSPHERIC CORR header handling, and the same
epoch-matching rule (first record whose TOC is within [-1 h, +1 h) of the
observation time, rinex.cpp:27-44).

Output is both a per-SV record list (scenario bookkeeping) and a
structure-of-arrays view (`EphArrays`) that feeds the vectorized orbit
propagator directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .constants import (
    MAX_SAT,
    OMEGA_EARTH,
    SECONDS_IN_HOUR,
    WGS_SQRT_GM,
)
from .gnss_time import DateTime, GalTime, date2gal


@dataclass
class IonoUtc:
    """Ionospheric (NeQuick-G ai) + GST-UTC header parameters."""

    enable: bool = True
    vflg: bool = False
    ai0: float = 0.0
    ai1: float = 0.0
    ai2: float = 0.0
    ai3: float = 0.0
    A0: float = 0.0
    A1: float = 0.0
    A2: float = 0.0
    dtls: int = 18
    tot: int = 0
    wnt: int = 0
    dtlsf: int = 18
    dn: int = 7
    wnlsf: int = 0


@dataclass
class Ephemeris:
    """One Galileo broadcast record (E1-B source), plus derived terms."""

    svid: int
    toc: GalTime
    toe: GalTime
    af0: float
    af1: float
    af2: float
    iode: int
    crs: float
    deltan: float
    m0: float
    cuc: float
    ecc: float
    cus: float
    sqrta: float
    cic: float
    omg0: float
    cis: float
    inc0: float
    crc: float
    aop: float
    omgdot: float
    idot: float
    flag: int
    week: int
    sisa: float
    svhlth: int
    bgde5a: float
    bgde5b: float
    ura: int
    # derived (rinex.cpp:226-230)
    A: float = 0.0
    n: float = 0.0
    sq1e2: float = 0.0
    omgkdot: float = 0.0

    # Aliases used by geodesy.satpos (SoA-compatible attribute names).
    @property
    def toe_sec(self) -> float:
        return self.toe.sec

    @property
    def toc_sec(self) -> float:
        return self.toc.sec


@dataclass
class EphArrays:
    """Structure-of-arrays ephemeris view for vectorized satpos."""

    m0: np.ndarray
    n: np.ndarray
    ecc: np.ndarray
    sqrta: np.ndarray
    A: np.ndarray
    sq1e2: np.ndarray
    aop: np.ndarray
    cuc: np.ndarray
    cus: np.ndarray
    crc: np.ndarray
    crs: np.ndarray
    cic: np.ndarray
    cis: np.ndarray
    inc0: np.ndarray
    idot: np.ndarray
    omg0: np.ndarray
    omgkdot: np.ndarray
    toe_sec: np.ndarray
    toc_sec: np.ndarray
    af0: np.ndarray
    af1: np.ndarray
    af2: np.ndarray
    bgde5b: np.ndarray

    @classmethod
    def from_records(cls, records: list[Ephemeris]) -> "EphArrays":
        def col(name):
            if name == "toe_sec":
                return np.array([r.toe.sec for r in records], dtype=np.float64)
            if name == "toc_sec":
                return np.array([r.toc.sec for r in records], dtype=np.float64)
            return np.array([getattr(r, name) for r in records], dtype=np.float64)

        return cls(**{f: col(f) for f in cls.__dataclass_fields__})

    def reshape(self, shape) -> "EphArrays":
        return EphArrays(
            **{f: getattr(self, f).reshape(shape) for f in self.__dataclass_fields__}
        )


@dataclass
class NavData:
    """Parsed navigation file: per-SV record lists + header parameters."""

    eph: list[list[Ephemeris]] = field(
        default_factory=lambda: [[] for _ in range(MAX_SAT)]
    )
    iono: IonoUtc = field(default_factory=IonoUtc)

    def epoch_match(self, sv: int, t: GalTime) -> int:
        """Index of the first record with TOC within [-1 h, +1 h) of t, or -1
        (rinex.cpp:27-44)."""
        for i, rec in enumerate(self.eph[sv]):
            dt = t - rec.toc
            if -SECONDS_IN_HOUR <= dt < SECONDS_IN_HOUR:
                return i
        return -1

    def time_window(self) -> tuple[GalTime, GalTime]:
        """(gmin, gmax) scenario bounds, replicating the reference's scan:
        gmin = TOC of the first SV with records (galileo-sdr.cpp:230-245);
        gmax = latest second-to-last TOC among SVs with >= 2 records
        (galileo-sdr.cpp:257-270)."""
        gmin = None
        for recs in self.eph:
            if recs:
                gmin = recs[0].toc
                break
        if gmin is None:
            raise ValueError("navigation file contains no usable records")
        gmax = GalTime(0, 0.0)
        for recs in self.eph:
            if len(recs) < 2:
                continue
            toc = recs[-2].toc
            if toc.sec > gmax.sec:
                gmax = toc
        return gmin, gmax


def _f(s: str) -> float:
    s = s.strip().replace("D", "E").replace("d", "E")
    return float(s) if s else 0.0


def _fields(line: str) -> list[float]:
    line = line.rstrip("\n")
    return [_f(line[c : c + 19]) for c in (4, 23, 42, 61)]


def getGalileoUra(data: float) -> int:
    """SISA [m] -> URA index (rinex.cpp:56-70)."""
    value = int(data * 100)
    if value < 0 or value > 6000:
        return 255
    if value < 50:
        return value
    if value < 100:
        return (value - 50) // 2 + 50
    if value < 200:
        return (value - 100) // 4 + 75
    return (value - 200) // 16 + 100


def read_rinex_v3(path: str | Path) -> NavData:
    nav = NavData()
    with open(path, "r") as fh:
        lines = fh.read().splitlines()

    i = 0
    # --- header -------------------------------------------------------
    while i < len(lines):
        line = lines[i]
        i += 1
        label = line[60:].rstrip()
        if label.startswith("END OF HEADER"):
            break
        if label.startswith("IONOSPHERIC CORR"):
            # "GAL" ai0 ai1 ai2 [ai3]  (rinex.cpp:128-132 reads 4 floats)
            vals = line[4:60].replace("D", "E").split()
            for k, name in enumerate(("ai0", "ai1", "ai2", "ai3")):
                if k < len(vals):
                    setattr(nav.iono, name, float(vals[k]))
            nav.iono.vflg = True
        if label.startswith("TIME SYSTEM CORR") and line.startswith("GAUT"):
            # rinex.cpp:135-157: A0 from cols 4-21, then A1 + two ints.
            nav.iono.A0 = _f(line[4:22])
            rest = line[22:60].replace("D", "E").split()
            nav.iono.A1 = float(rest[0]) if rest else 0.0
            data1 = int(float(rest[1])) if len(rest) > 1 else 0
            data2 = int(float(rest[2])) if len(rest) > 2 else 0
            nav.iono.tot = (data1 >> 12) & 0xFF
            nav.iono.wnt = _to_short(data2) >> 4
            nav.iono.wnlsf = _to_short(data2)
            nav.iono.A2 = 0.0
            nav.iono.dtls = 18
            nav.iono.dtlsf = 18
            nav.iono.dn = 7

    # --- body ---------------------------------------------------------
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.startswith("E"):
            continue
        try:
            svid = int(line[1:3])
        except ValueError:
            continue
        y, m, d, hh, mm = (
            int(line[4:8]),
            int(line[9:11]),
            int(line[12:14]),
            int(line[15:17]),
            int(line[18:20]),
        )
        ss = int(line[21:23])
        af = [_f(line[c : c + 19]) for c in (23, 42, 61)]
        data = [0.0] * 3 + sum((_fields(lines[i + k]) for k in range(7)), [])
        data[0:3] = af
        i += 7

        toc = date2gal(DateTime(y, m, d, hh, mm, float(ss)))
        flag = int(data[20])
        if flag != 517:  # E1-B data source only (rinex.cpp:218)
            continue

        sqrta = data[10]
        ecc = data[8]
        rec = Ephemeris(
            svid=svid,
            toc=toc,
            toe=GalTime(int(data[21]), float(int(data[11] + 0.5))),
            af0=data[0],
            af1=data[1],
            af2=data[2],
            iode=int(data[3]) & 0xFF,  # (unsigned char) cast, rinex.cpp:212
            crs=data[4],
            deltan=data[5],
            m0=data[6],
            cuc=data[7],
            ecc=ecc,
            cus=data[9],
            sqrta=sqrta,
            cic=data[12],
            omg0=data[13],
            cis=data[14],
            inc0=data[15],
            crc=data[16],
            aop=data[17],
            omgdot=data[18],
            idot=data[19],
            flag=flag,
            week=int(data[21]),
            sisa=data[23],
            svhlth=int(data[24]) & 0xFFFF,
            bgde5a=data[25],
            bgde5b=data[25] if (flag & 0x2) else data[26],
            ura=getGalileoUra(data[23]),
        )
        rec.A = sqrta * sqrta
        rec.n = WGS_SQRT_GM / (sqrta * rec.A) + rec.deltan
        rec.sq1e2 = float(np.sqrt(1.0 - ecc * ecc))
        rec.omgkdot = rec.omgdot - OMEGA_EARTH
        if 1 <= svid <= MAX_SAT:
            nav.eph[svid - 1].append(rec)
    return nav


def _to_short(v: int) -> int:
    """C (short) cast with sign."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v
