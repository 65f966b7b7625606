"""Standalone RINEX parser harness.

Counterpart of the reference's utils/rinex_reader.cpp (minus its
hard-coded path): parses a RINEX v3 Galileo navigation file and prints
header parameters and per-SV records for inspection.

  python -m galileo_sdr_sim_tpu.utils.rinex_dump nav.rnx [--prn N]
"""

from __future__ import annotations

import argparse
import sys

from ..rinex import read_rinex_v3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("navfile")
    p.add_argument("--prn", type=int, help="only this PRN")
    args = p.parse_args(argv)

    nav = read_rinex_v3(args.navfile)
    io = nav.iono
    print(f"IONO ai0={io.ai0} ai1={io.ai1} ai2={io.ai2} vflg={io.vflg}")
    print(f"GAUT A0={io.A0} A1={io.A1} tot={io.tot} wnt={io.wnt}")
    for sv, recs in enumerate(nav.eph):
        if not recs or (args.prn and args.prn != sv + 1):
            continue
        print(f"\nE{sv + 1:02d}: {len(recs)} records")
        for r in recs:
            print(
                f"  toc={r.toc.week}:{r.toc.sec:.0f} toe={r.toe.sec:.0f} "
                f"iodnav={r.iode} sqrta={r.sqrta:.6f} ecc={r.ecc:.3e} "
                f"m0={r.m0:.6f} af0={r.af0:.3e} hlth={r.svhlth} ura={r.ura}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
