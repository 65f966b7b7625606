"""GST/UTC time conversions.

Behavioural port of the reference time layer (reference: src/gnss-time.cpp).
Weeks are counted from the GPS epoch 1980-01-06 (the reference reuses GPS
week numbering internally and subtracts 1024 when writing the I/NAV WN
field, inav-msg.cpp:203).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .constants import (
    SECONDS_IN_DAY,
    SECONDS_IN_HOUR,
    SECONDS_IN_MINUTE,
    SECONDS_IN_WEEK,
)

_DOY = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)


@dataclass(frozen=True)
class GalTime:
    """Week (GPS numbering) + seconds of week."""

    week: int
    sec: float

    def __add__(self, dt: float) -> "GalTime":
        # Deviation from incGalTime (gnss-time.cpp:88-92), which never
        # rolls seconds into the week — the reference's week-rollover
        # handling is commented out (inav-msg.cpp:181-183), so its TOW
        # exceeds 604799 and WN goes stale after a Saturday-night
        # boundary.  We roll correctly per the ICD (TOW in [0, 604800),
        # WN increments); pinned by
        # tests/test_baseline_configs.py::test_config5_week_rollover_mid_run.
        return GalTime(self.week, self.sec + dt).normalized()

    def __sub__(self, other: "GalTime") -> float:
        return (self.sec - other.sec) + (self.week - other.week) * SECONDS_IN_WEEK

    def normalized(self) -> "GalTime":
        """Roll seconds into [0, 604800), adjusting the week."""
        w, s = self.week, self.sec
        dw = int(s // SECONDS_IN_WEEK)
        return GalTime(w + dw, s - dw * SECONDS_IN_WEEK)


@dataclass
class DateTime:
    y: int
    m: int
    d: int
    hh: int
    mm: int
    sec: float


def date2gal(t: DateTime) -> GalTime:
    """UTC calendar date -> week/seconds (gnss-time.cpp:7-29)."""
    ye = t.y - 1980
    lpdays = ye // 4 + 1
    if ye % 4 == 0 and t.m <= 2:
        lpdays -= 1
    de = ye * 365 + _DOY[t.m - 1] + t.d + lpdays - 6
    week = de // 7
    sec = (
        float(de % 7) * SECONDS_IN_DAY
        + t.hh * SECONDS_IN_HOUR
        + t.mm * SECONDS_IN_MINUTE
        + t.sec
    )
    return GalTime(week, sec)


def gal2date(g: GalTime) -> DateTime:
    """Week/seconds -> UTC calendar date (gnss-time.cpp:31-48)."""
    c = int(7 * g.week + math.floor(g.sec / 86400.0) + 2444245.0) + 1537
    d = int((c - 122.1) / 365.25)
    e = 365 * d + d // 4
    f = int((c - e) / 30.6001)

    day = c - e - int(30.6001 * f)
    month = f - 1 - 12 * (f // 14)
    year = d - 4715 - ((7 + month) // 10)

    hh = int(g.sec / 3600.0) % 24
    mm = int(g.sec / 60.0) % 60
    sec = g.sec - 60.0 * math.floor(g.sec / 60.0)
    return DateTime(year, month, day, hh, mm, sec)


def gps_time_of_week(t: DateTime) -> float:
    """Seconds into the GPS week for a 2-digit-year date (gnss-time.cpp:51-76).

    Note the reference treats DateTime.y as a 2-digit year here (adds 2000);
    callers pass 4-digit years, making this an offset computation only used
    for relative comparisons.  Kept for behavioural parity.
    """
    y, m, d = float(t.y), float(t.m), float(t.d)
    utc = t.hh + t.mm / 60.0 + t.sec / 3600.0
    if m > 2:
        y = y + 2000
    else:
        y = y + 2000 - 1
        m = m + 12
    jdate = math.floor(365.25 * y) + math.floor(30.6001 * (m + 1)) + d + utc / 24 + 1720981.5
    week = math.floor((jdate - 2444244.5) / 7)
    return round((((jdate - 2444244.5) / 7 - week) * 7 * 24 * 3600) * 100) / 100
