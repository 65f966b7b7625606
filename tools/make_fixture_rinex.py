"""Write tests/data/obs_fixture_nav.rnx: a RINEX v3 Galileo navigation file
built from the broadcast ephemerides already stored in
tests/data/obs_ref_fixture.json (real records of the 20 Feb 2022 file).

The nav file lets the CLI, the streaming pipeline and their tests drive
a real scene without an external RINEX file:

    python tools/make_fixture_rinex.py

Layout, as read back by galileo_sdr_sim_tpu.rinex.read_rinex_v3:

* header: the fixture's Galileo iono coefficients as
  `IONOSPHERIC CORR GAL`;
* body: one E record per fixture ephemeris, data sources 517 (E1-B), the
  broadcast-orbit fields in the parser's order (rinex.py data[0..26]) in
  D19.12 format.  The GST week is 2197 for TOC > 300000 s and 2198
  otherwise (the fixture spans the 2197/2198 week rollover).

Fields the fixture does not carry get fixed stand-ins: IODnav is
derived from TOE (toe / 600 mod 128), SISA is 3.12 m, health is 0.

Every record is written TWICE.  `NavData.time_window` takes the scenario
end (gmax) from the second-to-last TOC of each SV with at least two
records (the reference's scan, galileo-sdr.cpp:257-270); with a single
record per SV there would be no gmax and every start time after gmin
would be rejected.  The duplicate changes nothing else: the epoch match
returns the first record within the +-1 h window.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "obs_ref_fixture.json"
OUT = REPO / "tests" / "data" / "obs_fixture_nav.rnx"

sys.path.insert(0, str(REPO))

from galileo_sdr_sim_tpu.gnss_time import GalTime, gal2date  # noqa: E402

DATA_SOURCES = 517.0
SISA_M = 3.12
ROLLOVER_SEC = 300000.0


def week_of(toc_sec: float) -> int:
    return 2197 if toc_sec > ROLLOVER_SEC else 2198


def d19(v: float) -> str:
    return f"{float(v):19.12E}".replace("E", "D")


def record_lines(e: dict) -> list[str]:
    """One E record (8 lines) in the column layout rinex.py parses."""
    week = week_of(e["toc_sec"])
    t = gal2date(GalTime(week, float(e["toc_sec"])))
    head = (
        f"E{e['svid']:02d} {t.y:04d} {t.m:02d} {t.d:02d} {t.hh:02d} "
        f"{t.mm:02d} {int(t.sec):02d}"
    )
    iode = float(int(e["toe_sec"] // 600) % 128)
    # rinex.py data[3..30]: seven broadcast-orbit lines of four fields
    orbit = [
        (iode, e["crs"], e["deltan"], e["m0"]),
        (e["cuc"], e["ecc"], e["cus"], e["sqrta"]),
        (e["toe_sec"], e["cic"], e["omg0"], e["cis"]),
        (e["inc0"], e["crc"], e["aop"], e["omgdot"]),
        (e["idot"], DATA_SOURCES, float(week), 0.0),
        (SISA_M, 0.0, e["bgde5a"], e["bgde5b"]),
        (e["toc_sec"], 0.0, 0.0, 0.0),
    ]
    lines = [head + d19(e["af0"]) + d19(e["af1"]) + d19(e["af2"])]
    lines += ["    " + "".join(d19(v) for v in row) for row in orbit]
    return lines


def header_lines(iono: dict) -> list[str]:
    ai = [iono["ai0"], iono["ai1"], iono["ai2"], 0.0]
    coeffs = "".join(f"{v:12.4E}".replace("E", "D") for v in ai)
    return [
        f"{'     3.05':<20}{'N: GNSS NAV DATA':<20}{'E: GALILEO':<20}"
        "RINEX VERSION / TYPE",
        f"{'GAL ' + coeffs:<60}IONOSPHERIC CORR",
        f"{'':<60}END OF HEADER",
    ]


def main() -> None:
    fix = json.loads(FIXTURE.read_text())
    lines = header_lines(fix["iono_header"])
    for e in sorted(fix["eph"].values(), key=lambda e: e["svid"]):
        rec = record_lines(e)
        lines += rec + rec
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT.relative_to(REPO)}: {len(fix['eph'])} SVs x 2 records")


if __name__ == "__main__":
    main()
