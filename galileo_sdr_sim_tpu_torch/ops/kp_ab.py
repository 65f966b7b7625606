"""The kp kernel of this checkout against another checkout's, in one
process on one GPU.

    python -m galileo_sdr_sim_tpu_torch.ops.kp_ab OTHER [--label TEXT]
        [--record-digests FILE] [--json FILE]

OTHER is the root of another checkout of the repository (for instance
`git archive` of the parent commit unpacked into a git-ignored
directory).  Its package is loaded beside this one under another name,
so each side runs its own wrappers and its own kernel source, built by
its own `_build` into its own `_kernels_build/`.  JAX and the JAX
package are blocked from import first.  Phases:

1. both kernel libraries built in parallel; each kernel's registers and
   spills (`ptxas -v`);
2. the SASS instruction classes of each kernel function, whole and in
   its main loop (ops/measure.py);
3. the digests of every instantiation on `harness.kp_digest_cases`,
   other side and this side; `--record-digests FILE` writes the other
   side's as the recorded digests (with the card, torch, CUDA and nvcc
   versions, and `--label` naming the other side's kernel);
4. device time of every instantiation at B = 8 with C = 2, 8 and 16 and
   at B = 1 with C = 8, full 0.1 s epochs, in turns other, this, this,
   other (CUDA events behind a sleep kernel, ops/measure.median_ms);
5. the CLI files of both sides for 3 s runs of the fixture scene (the
   default run, `--model cboc --apply-gain`, `--bandlimit
   --apply-gain`), compared byte for byte.

It exits 1 when a digest or a CLI file differs.
"""

from __future__ import annotations

import argparse
import filecmp
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import cli, harness
from .._block_reference import install
from . import measure, synth_kp_cuda
from ._build import find_nvcc

ROOT = Path(__file__).resolve().parents[2]
NAV = ROOT / "tests" / "data" / "obs_fixture_nav.rnx"
# (B, C) of the timed points: the file-sink block at three channel counts,
# and the one-epoch block of interactive (live) mode
POINTS = ((8, 2), (8, 8), (8, 16), (1, 8))
CLI_RUNS = ([], ["--model", "cboc", "--apply-gain"], ["--bandlimit", "--apply-gain"])
CLI_SECONDS = 3


def load_other(root: Path, name: str = "kp_other"):
    """Import the port package of the checkout at `root` as `name`."""
    pkg = root / "galileo_sdr_sim_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--label", default="other", help="what the other side is, for the records")
    ap.add_argument("--record-digests", type=Path, help="write the other side's digests here")
    ap.add_argument("--json", type=Path, help="write the summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the A/B run needs one GPU")
        return 1
    install()
    other_pkg = load_other(args.other.resolve())
    other = importlib.import_module(f"{other_pkg.__name__}.ops.synth_kp_cuda")
    other_cli = importlib.import_module(f"{other_pkg.__name__}.cli")
    dev = torch.device("cuda", 0)
    gpu = card()
    print(f"card: {gpu}")
    summary = {"card": gpu, "other": args.label, "torch": torch.__version__,
               "cuda": torch.version.cuda, "nvcc": nvcc_version()}
    ok = True

    # 1-2. builds, registers and spills, SASS classes
    with ThreadPoolExecutor(2) as pool:
        futs = {"other": pool.submit(other.library), "this": pool.submit(synth_kp_cuda.library)}
        built = {side: f.result()[1] for side, f in futs.items()}
    summary["sass"], summary["ptxas"] = {}, {}
    for side, b in built.items():
        print(f"build {side}: {b.path.name} in {b.seconds:.2f} s")
        summary["ptxas"][side] = {measure.kp_function(k): v
                                  for k, v in measure.ptxas_summary(b.log).items()}
        summary["sass"][side] = {measure.kp_function(k): v
                                 for k, v in measure.sass_counts(b.path).items()}
        for fn, line in summary["ptxas"][side].items():
            print(f"ptxas {side} {fn}: {line}")
        for fn, counts in summary["sass"][side].items():
            for part in ("kernel", "loop"):
                text = " ".join(f"{k}={v}" for k, v in counts[part].items())
                print(f"sass {side} {fn} {part}: {text}")

    # 3. digests
    digests = {side: {name: harness.kp_digests(mod, name, NAV, dev)
                      for name in harness.KP_INSTANTIATIONS}
               for side, mod in (("other", other), ("this", synth_kp_cuda))}
    n = sum(len(v) for v in digests["other"].values())
    same = sum(digests["this"][name][key] == d
               for name, cases in digests["other"].items() for key, d in cases.items())
    for name, cases in digests["other"].items():
        for key, d in cases.items():
            if digests["this"][name][key] != d:
                print(f"digest differs: {name} {key}")
    print(f"digests: {same} of {n} equal")
    summary["digests_equal"], summary["digests"] = same, n
    ok &= same == n
    if args.record_digests:
        record = {"made_with": {"kernel": f"{args.label}, -fmad=true", "card": gpu,
                                "torch": torch.__version__, "cuda": torch.version.cuda,
                                "nvcc": summary["nvcc"]},
                  "digests": digests["other"]}
        args.record_digests.write_text(json.dumps(record, indent=1) + "\n")
        print(f"recorded {n} digests of {args.label} in {args.record_digests}")

    # 4. timings, in turns other, this, this, other
    summary["ms"] = {}
    for name, (variant, f32) in harness.KP_INSTANTIATIONS.items():
        for B, C in POINTS:
            inputs = harness.synthetic_kp_inputs(B, C, 100 + C, "random", dev, **variant)
            fns = {side: (mod.synth_kp_accum if f32 else mod.synth_kp_packed)
                   for side, mod in (("other", other), ("this", synth_kp_cuda))}
            t = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                t[side].append(measure.median_ms(lambda: fns[side](inputs, harness.K_EPOCH)))
            mean = {side: sum(v) / len(v) for side, v in t.items()}
            summary["ms"][f"{name} B={B} C={C}"] = t
            print(f"time {name} B={B} C={C}: other {t['other']} this {t['this']} ms, "
                  f"mean {mean['other']:.4f} -> {mean['this']:.4f} "
                  f"({mean['other'] / mean['this']:.2f}x) ({gpu})")

    # 5. the CLI files, byte for byte
    summary["cli_identical"] = {}
    llh = ",".join(str(v) for v in harness.FIXTURE_LLH)
    with tempfile.TemporaryDirectory(prefix=".smoke_ab_", dir=ROOT) as tmp:
        for options in CLI_RUNS:
            files = {}
            for side, main_fn in (("other", other_cli.main), ("this", cli.main)):
                files[side] = Path(tmp) / f"{side}.ishort"
                rc = main_fn(["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(CLI_SECONDS),
                              "-t", harness.FIXTURE_START, "-l", llh, "-o", str(files[side]),
                              *options])
                ok &= rc == 0
            same_file = filecmp.cmp(files["other"], files["this"], shallow=False)
            label = " ".join(options) or "default"
            print(f"cli {label} {CLI_SECONDS} s: {files['this'].stat().st_size} bytes, "
                  f"byte-identical={same_file}")
            summary["cli_identical"][label] = same_file
            ok &= same_file
    if args.json:
        args.json.write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({"ok": bool(ok), "digests_equal": same, "digests": n}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
