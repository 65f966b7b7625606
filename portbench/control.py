"""The control of the comparison that decides `correct`, at a cell's own
size: the plain reference put in the program's place and computed one
precision step below what the configuration states (the carrier and the
channel sum in bfloat16; band-limited, the filter in float32 with TF32
allowed as well), read against the float64 reference on the same epochs
a run checks, for each seed.  It must come out as not correct.  The
benchmark's runs do not run it.

`--fault history_reset` (band-limited cells) reads a fault instead: the
reference at full precision with the filter's history zero at every
block's edge (every epoch e % block_epochs == 0), as a stream that drops
its filter state between blocks would give; each job checks one such
epoch, and `max_abs` has to fail it.

    python3 portbench/control.py --workload e1_os.file_b8 --seeds 11,12,13
    python3 portbench/control.py --workload e1_cboc_bl.file_b8 --seeds 11,12,13 \
        --fault history_reset
"""

import argparse
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from portbench.harness.check import epoch_numbers, reference_epochs  # noqa: E402
from portbench.harness.jobs import draw_job  # noqa: E402
from portbench.harness.spec import ROOT, load_cell  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--fault", choices=("history_reset",), default=None,
                   help="read this fault instead of the precision control")
    args = p.parse_args()
    cell = load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    device = torch.device("cuda", 0)
    nav = str(ROOT / cfg["nav_file"])
    bl = cfg["bandlimit"]
    limits = cfg["checks"]
    if args.fault and not bl:
        raise SystemExit(f"--fault {args.fault} needs a band-limited cell")
    what = args.fault or "control"
    for seed in (int(s) for s in args.seeds.split(",")):
        worst = {"off1_pct": 0.0, "dense_pct": 0.0, "max_abs": 0}
        for j in range(traffic["check_jobs"]):
            job = draw_job(traffic, seed, j)
            epochs = sorted(job.check)
            ref = reference_epochs(job, epochs, cfg, nav, device)
            if args.fault:
                ctl = reference_epochs(job, epochs, cfg, nav, device,
                                       reset_every=traffic["block_epochs"])
            else:
                ctl = reference_epochs(job, epochs, cfg, nav, device, torch.bfloat16, bl)
            for e in epochs:
                numbers = epoch_numbers(ctl[e], ref[e])
                for k, v in zip(worst, numbers):
                    worst[k] = max(worst[k], v)
                print(f"seed {seed} job {j} epoch {e}: {what} off1 {numbers[0]:.6f}% dense "
                      f"{numbers[1]:.6f}% max_abs {numbers[2]}")
        fails = [k for k, v in worst.items() if k in limits and v > limits[k]]
        print(f"seed {seed}: worst {what} off1 {worst['off1_pct']:.6f}% dense "
              f"{worst['dense_pct']:.6f}% max_abs {worst['max_abs']}; fails "
              f"{fails or 'nothing'} of the limits {limits}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
