"""The hand-written kernels of this checkout against other checkouts', in
one process on one GPU.

    python -m galileo_sdr_sim_tpu_torch.ops.kp_ab OTHER [OTHER ...]
        [--label TEXT] [--record-digests FILE] [--json FILE] [--no-cli]

Each OTHER is the root of another checkout of the repository (for
instance `git archive` of the parent commit, or of one step of a change,
unpacked into a git-ignored directory); a side is named by its
directory.  Each package is loaded beside this one under another name,
so each side runs its own wrappers and its own kernel sources, built by
its own `_build` into its own `_kernels_build/`.  JAX and the JAX package
are blocked from import first.  Phases:

1. every side's kernel libraries built in parallel; each kernel's
   registers and spills (`ptxas -v`);
2. the SASS instruction classes of each kp kernel function, whole and in
   its main loop (ops/measure.py);
3. the digests of every kp instantiation on `harness.kp_digest_cases`,
   every side against this one; `--record-digests FILE` writes the first
   OTHER's as the recorded digests (with the card, torch, CUDA and nvcc
   versions, and `--label` naming that side's kernel); the prologue's
   decoded planes of every side against this one's with `torch.equal`;
   the gather's seven outputs against `torch.take_along_dim`;
4. device time, in turns other(s), this, this, other(s) (CUDA events
   behind a sleep kernel, ops/measure.median_ms), at B = 8 with C = 2, 8
   and 16 and at B = 1 with C = 8, full 0.1 s epochs: every kp
   instantiation (a call is the prologue and the main kernel), the
   prologue alone; the wrapper's host time a call at B = 8, C = 8; the
   gather kernel on the seven probe shapes; and this side's launch
   floors (empty kernels of the same grids and block sizes);
5. the CLI files of every side for 3 s runs of the fixture scene (the
   default run, `--model cboc --apply-gain`, `--bandlimit
   --apply-gain`), compared byte for byte with this side's.

It exits 1 when a digest, a plane, a gather output or a CLI file differs.
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
from . import gather_probe, measure, synth_kp_cuda
from ._build import find_nvcc

ROOT = Path(__file__).resolve().parents[2]
NAV = ROOT / "tests" / "data" / "obs_fixture_nav.rnx"
THIS = "this"
# (B, C) of the timed points: the file-sink block at three channel counts,
# and the one-epoch block of interactive (live) mode
POINTS = ((8, 2), (8, 8), (8, 16), (1, 8))
CLI_RUNS = ([], ["--model", "cboc", "--apply-gain"], ["--bandlimit", "--apply-gain"])
CLI_SECONDS = 3


def load_other(root: Path, name: str):
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


def in_turns(sides: list, fns: dict, timer=measure.median_ms) -> dict:
    """{side: [two times]} of `fns[side]`, timed in the order others,
    this, this, others reversed."""
    others = [s for s in sides if s != THIS]
    t = {side: [] for side in sides}
    for side in (*others, THIS, THIS, *reversed(others)):
        t[side].append(timer(fns[side]))
    return t


def report(what: str, t: dict, gpu: str) -> None:
    mean = {side: sum(v) / len(v) for side, v in t.items()}
    text = ", ".join(f"{side} {v[0]:.5f} {v[1]:.5f}" for side, v in t.items())
    ratios = ", ".join(f"{side}/this {mean[side] / mean[THIS]:.2f}x" for side in t if side != THIS)
    print(f"time {what}: {text} ms; {ratios} ({gpu})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+", help="roots of the other checkouts")
    ap.add_argument("--label", default="other", help="what the first other side is, for the records")
    ap.add_argument("--record-digests", type=Path, help="write the first other side's digests here")
    ap.add_argument("--json", type=Path, help="write the summary here")
    ap.add_argument("--no-cli", action="store_true", help="skip phase 5, the CLI files")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the A/B run needs one GPU")
        return 1
    install()
    kp, gather, clis = {}, {}, {}
    for i, root in enumerate(args.others):
        pkg = load_other(root.resolve(), f"kp_other_{i}")
        side = root.name
        kp[side] = importlib.import_module(f"{pkg.__name__}.ops.synth_kp_cuda")
        gather[side] = importlib.import_module(f"{pkg.__name__}.ops.gather_probe")
        clis[side] = importlib.import_module(f"{pkg.__name__}.cli")
    first = args.others[0].name
    kp[THIS], gather[THIS], clis[THIS] = synth_kp_cuda, gather_probe, cli
    sides = list(kp)
    dev = torch.device("cuda", 0)
    gpu = card()
    print(f"card: {gpu}")
    summary = {"card": gpu, "sides": sides, "torch": torch.__version__,
               "cuda": torch.version.cuda, "nvcc": nvcc_version()}
    ok = True

    # 1-2. builds, registers and spills, SASS classes
    with ThreadPoolExecutor(2 * len(sides) + 1) as pool:
        futs = {side: (pool.submit(kp[side].library), pool.submit(gather[side].library))
                for side in sides}
        floor = pool.submit(measure.floor_library)
        built = {side: tuple(f.result()[1] for f in pair) for side, pair in futs.items()}
        floor.result()
    summary["sass"], summary["ptxas"] = {}, {}
    for side, (b, g) in built.items():
        print(f"build {side}: {b.path.name} in {b.seconds:.2f} s, {g.path.name} in {g.seconds:.2f} s")
        summary["ptxas"][side] = {measure.kp_function(k): v
                                  for k, v in measure.ptxas_summary(b.log + g.log).items()}
        summary["sass"][side] = {measure.kp_function(k): v
                                 for k, v in measure.sass_counts(b.path).items()}
        for fn, line in summary["ptxas"][side].items():
            print(f"ptxas {side} {fn}: {line}")
        for fn, counts in summary["sass"][side].items():
            for part in ("kernel", "loop"):
                text = " ".join(f"{k}={v}" for k, v in counts[part].items())
                print(f"sass {side} {fn} {part}: {text}")

    # 3. digests, planes, gather outputs
    digests = {side: {name: harness.kp_digests(mod, name, NAV, dev)
                      for name in harness.KP_INSTANTIATIONS}
               for side, mod in kp.items()}
    n = sum(len(v) for v in digests[THIS].values())
    summary["digests"], summary["digests_equal"] = n, {}
    for side in sides:
        if side == THIS:
            continue
        differ = [f"{name} {key}" for name, cases in digests[THIS].items()
                  for key, d in cases.items() if digests[side][name][key] != d]
        for what in differ:
            print(f"digest differs from {side}: {what}")
        print(f"digests {side}: {n - len(differ)} of {n} equal")
        summary["digests_equal"][side] = n - len(differ)
        ok &= not differ
    if args.record_digests:
        record = {"made_with": {"kernel": f"{args.label}, -fmad=true", "card": gpu,
                                "torch": torch.__version__, "cuda": torch.version.cuda,
                                "nvcc": summary["nvcc"]},
                  "digests": digests[first]}
        args.record_digests.write_text(json.dumps(record, indent=1) + "\n")
        print(f"recorded {n} digests of {args.label} in {args.record_digests}")

    summary["planes_equal"] = {}
    plane_cases = [(f"C={C} {case}", harness.synthetic_kp_inputs(8, C, 100 + C, case, dev, cboc=cboc))
                   for C in harness.DIGEST_CS
                   for case, cboc in (("random", False), ("edges", True), ("negated_mu", False))]
    plane_cases.append(("B=1 C=8 random", harness.synthetic_kp_inputs(1, 8, 108, "random", dev)))
    planes = {side: [mod.kp_planes(inputs, harness.K_EPOCH) for _, inputs in plane_cases]
              for side, mod in kp.items()}
    torch.cuda.synchronize()
    for side in sides:
        if side == THIS:
            continue
        differ = [f"{key} {plane}" for (key, _), a, b in zip(plane_cases, planes[side], planes[THIS])
                  for plane in b if not torch.equal(a[plane], b[plane])]
        print(f"planes {side}: {len(plane_cases) - len({d.rsplit(' ', 1)[0] for d in differ})} of "
              f"{len(plane_cases)} cases byte-equal {differ or ''}")
        summary["planes_equal"][side] = not differ
        ok &= not differ
    del planes

    gen = torch.Generator().manual_seed(0)
    probes = [(shape, axis, *(t.to(dev) for t in gather_probe.probe_inputs(shape, maxidx, gen)))
              for shape, maxidx, axis in gather_probe.PROBES]
    for side, mod in gather.items():
        same = all(torch.equal(mod.take_along_axis(tab, idx, axis),
                               torch.take_along_dim(tab, idx.long(), dim=axis))
                   for _, axis, tab, idx in probes)
        print(f"gather {side}: the seven outputs equal torch.take_along_dim: {same}")
        ok &= same

    # 4. timings, in turns
    summary["ms"] = {}
    for name, (variant, f32) in harness.KP_INSTANTIATIONS.items():
        for B, C in POINTS:
            inputs = harness.synthetic_kp_inputs(B, C, 100 + C, "random", dev, **variant)
            fns = {side: (lambda m=mod: (m.synth_kp_accum if f32 else m.synth_kp_packed)(
                inputs, harness.K_EPOCH)) for side, mod in kp.items()}
            what = f"{name} B={B} C={C}"
            summary["ms"][what] = in_turns(sides, fns)
            report(what, summary["ms"][what], gpu)
    summary["floor_ms"] = {}
    for B, C in POINTS:
        inputs = harness.synthetic_kp_inputs(B, C, 100 + C, "random", dev)
        # the prologue's launch alone: `kp_planes` would add the copy that
        # decodes the chip words out of the scratch
        fns = {side: (lambda m=mod: m._launch_planes(m.library()[0], inputs, harness.K_EPOCH))
               for side, mod in kp.items()}
        what = f"{synth_kp_cuda.PLANES} B={B} C={C}"
        summary["ms"][what] = in_turns(sides, fns)
        report(what, summary["ms"][what], gpu)
        geometry = synth_kp_cuda.launch_geometry(B, C)
        floors = {"prologue": measure.floor_ms(geometry[:1]), "pair": measure.floor_ms(geometry)}
        summary["floor_ms"][f"B={B} C={C}"] = floors
        print(f"floor B={B} C={C}: prologue {geometry[0]} {floors['prologue']:.5f} ms, pair "
              f"{geometry} {floors['pair']:.5f} ms ({gpu})")
    inputs = harness.synthetic_kp_inputs(8, 8, 108, "random", dev)
    fns = {side: (lambda m=mod: m.synth_kp_packed(inputs, harness.K_EPOCH)) for side, mod in kp.items()}
    summary["host_ms"] = in_turns(sides, fns, measure.host_ms)
    report("the wrapper's host time a call, synth_kp_v5 B=8 C=8", summary["host_ms"], gpu)
    for shape, axis, tab, idx in probes:
        fns = {side: (lambda m=mod: m.take_along_axis(tab, idx, axis)) for side, mod in gather.items()}
        what = f"gather {shape} axis={axis}"
        summary["ms"][what] = in_turns(sides, fns)
        report(what, summary["ms"][what], gpu)
        geometry = gather_probe.launch_geometry(*shape, axis)
        summary["floor_ms"][what] = measure.floor_ms([geometry])
        print(f"floor {what}: {geometry} {summary['floor_ms'][what]:.5f} ms ({gpu})")
    total = {side: sum(sum(summary["ms"][f"gather {shape} axis={axis}"][side]) / 2
                       for shape, axis, _, _ in probes) for side in sides}
    print("time gather, seven probes: " + ", ".join(f"{s} {v:.5f}" for s, v in total.items())
          + f" ms; floor {sum(v for k, v in summary['floor_ms'].items() if k.startswith('gather')):.5f}"
          f" ms ({gpu})")

    # 5. the CLI files, byte for byte
    summary["cli_identical"] = {}
    llh = ",".join(str(v) for v in harness.FIXTURE_LLH)
    with tempfile.TemporaryDirectory(prefix=".smoke_ab_", dir=ROOT) as tmp:
        for options in [] if args.no_cli else CLI_RUNS:
            files = {}
            for side, mod in clis.items():
                files[side] = Path(tmp) / f"{side}.ishort"
                rc = mod.main(["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(CLI_SECONDS),
                               "-t", harness.FIXTURE_START, "-l", llh, "-o", str(files[side]),
                               *options])
                ok &= rc == 0
            label = " ".join(options) or "default"
            same = {side: filecmp.cmp(files[side], files[THIS], shallow=False)
                    for side in sides if side != THIS}
            print(f"cli {label} {CLI_SECONDS} s: {files[THIS].stat().st_size} bytes, "
                  f"byte-identical to this side's: {same}")
            summary["cli_identical"][label] = same
            ok &= all(same.values())
    if args.json:
        args.json.write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({"ok": bool(ok), "digests": n, "digests_equal": summary["digests_equal"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
