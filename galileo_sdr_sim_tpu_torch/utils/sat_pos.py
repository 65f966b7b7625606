"""Satellite position / observables debug dumps.

Counterpart of the reference's debug.cpp `writecsv` + utils/sat_pos.py:
dumps per-(epoch, PRN) satpos / az-el / pseudorange time series to CSV for
offline comparison against other tools.

  python -m galileo_sdr_sim_tpu.utils.sat_pos -e nav.rnx \
      -t 2022/02/20,08:00:01 -l 42.36,-71.06,100 -d 30 -o satpos.csv
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from .. import geodesy
from ..constants import MAX_SAT, R2D
from ..observables import compute_range
from ..rinex import EphArrays, read_rinex_v3
from ..scenario import scenario_start_time
from ..cli import _parse_time


def dump(nav, g0, llh_deg, duration_s: float, out, step_s: float = 0.1) -> int:
    xyz = geodesy.llh2xyz(
        np.array([llh_deg[0] / R2D, llh_deg[1] / R2D, llh_deg[2]])
    )
    writer = csv.writer(out)
    writer.writerow(
        ["t_sec", "prn", "x", "y", "z", "vx", "vy", "vz", "az_deg", "el_deg",
         "range_m", "prange_m", "clk_s"]
    )
    nrows = 0
    times = g0.sec + np.arange(0, duration_s, step_s)
    for sv in range(MAX_SAT):
        idx = nav.epoch_match(sv, g0)
        if idx < 0:
            continue
        eph = nav.eph[sv][idx]
        arr = EphArrays.from_records([eph])
        pos, vel, clk = geodesy.satpos(arr, times[:, None])
        rho = compute_range(arr, nav.iono, g0.week, times[:, None], xyz)
        for i, t in enumerate(times):
            writer.writerow(
                [f"{t:.1f}", sv + 1]
                + [f"{v:.3f}" for v in pos[i, 0]]
                + [f"{v:.6f}" for v in vel[i, 0]]
                + [f"{rho.azel[i, 0, 0] * R2D:.4f}", f"{rho.azel[i, 0, 1] * R2D:.4f}"]
                + [f"{rho.d[i, 0]:.3f}", f"{rho.range[i, 0]:.3f}",
                   f"{clk[i, 0, 0]:.12f}"]
            )
            nrows += 1
    return nrows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-e", dest="navfile", required=True)
    p.add_argument("-t", dest="start", required=True)
    p.add_argument("-l", dest="llh", default="42.3601,-71.0589,100")
    p.add_argument("-d", dest="duration", type=float, default=30.0)
    p.add_argument("-o", dest="outfile", default="-")
    p.add_argument("--step", type=float, default=0.1)
    args = p.parse_args(argv)

    nav = read_rinex_v3(args.navfile)
    g0 = scenario_start_time(nav, _parse_time(args.start))
    llh = [float(v) for v in args.llh.split(",")]
    out = sys.stdout if args.outfile == "-" else open(args.outfile, "w")
    n = dump(nav, g0, llh, args.duration, out, args.step)
    if out is not sys.stdout:
        out.close()
    print(f"wrote {n} rows", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
