"""One run of one cell: set-up, the window, the check, the result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in `setup_s`, from the process's start): torch and CUDA,
the program's modules, the nav file parsed, the kernels built (the first
run in a checkout) or loaded, and one warm-up job of `warmup_seconds`
through the same path, which meets every shape the window uses (the
block is always padded to `block_epochs`).  Then the window (under
torch.profiler with `--trace 1`), then the check against the plain
reference, then the result: earlier lines say what ran, the last line of
standard output is the JSON result, and the compared numbers beside their
limits end standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

from . import device as machine
from .check import check_run
from .jobs import draw_job
from .spec import BENCH, ROOT, Cell, load_cell

BLOCKED = ("jax", "jaxlib", "flax", "galileo_sdr_sim_tpu")  # top-level module names
CACHE = ROOT / ".portbench_cache"


@dataclass
class Observation:
    """What the metric readers (portbench/metrics/<name>.py) read."""

    cell: Cell
    setup_s: float
    window_s: float
    samples: int
    sections: dict  # Timer section -> seconds, summed over the window's jobs
    trace: object  # trace.TraceSummary, or None without --trace


def blocked_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))


def read_metric(entry: dict, obs: Observation):
    path = BENCH / "metrics" / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Set-up, window and check on `device` -> the pieces of the result."""
    import torch

    t_init = time.perf_counter()
    from .trace import profiler, summarize
    from .window import Runner, Window, run_window  # the program's modules

    cuda = device.type == "cuda"
    t_mods = time.perf_counter()
    runner = Runner(cell.config, cell.traffic, ROOT, device)
    t_load = time.perf_counter()
    warm = runner.job(draw_job(cell.traffic, 0, 0, cell.traffic["warmup_seconds"]), None)
    if warm.error:
        raise RuntimeError(f"the warm-up job failed:\n{warm.error}")
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.6f} s: torch and the card {t_init - t0:.6f} s, the program's "
          f"modules {t_mods - t_init:.6f} s, the nav file {t_load - t_mods:.6f} s, the warm-up "
          f"job (kernels built or loaded) {t0 + setup_s - t_load:.6f} s")
    window = Window(seconds)
    with profiler() if trace else contextlib.nullcontext() as prof:
        results = run_window(runner, window, seed)
        if cuda:
            torch.cuda.synchronize(device)
    summary = None
    if trace:
        t_read = time.perf_counter()
        summary = summarize(prof)
        print(f"trace exported and read in {time.perf_counter() - t_read:.3f} s")
        del prof
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        print(f"card after the window: {machine.smi()}; host: {machine.host()}")
    sections, counts = {}, {}
    for r in results:
        for k, v in r.sections.items():
            sections[k] = sections.get(k, 0.0) + v
        for k, v in r.counts.items():
            counts[k] = counts.get(k, 0) + v
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = check_run(results, cell.config, cell.traffic, seed,
                      str(ROOT / cell.config["nav_file"]), device)
    obs = Observation(cell, setup_s, window.seconds, window.samples, sections, summary)
    return dict(results=results, check=check, obs=obs, peak=peak, counts=counts)


def report(cell: Cell, out: dict, trace: bool, device_info: dict) -> dict:
    """Print what ran -> the result line's dict."""
    results, check, obs = out["results"], out["check"], out["obs"]
    for r in results:
        where = "site" if r.job.trajectory is None else "moving from"
        lat, lon, hgt = r.job.llh
        print(f"job {r.job.index}: {where} {lat:.4f},{lon:.4f},{hgt:.1f} "
              f"start {r.job.start_arg}, {r.satellites} satellites, {r.epochs} of {r.expected} "
              f"epochs, {'to its end' if r.finished else 'cut by the window'}, fallback blocks "
              f"{r.counts.get('fallback_direct', 0)}{', FAILED' if r.error else ''}")
    print(f"window {obs.window_s:.3f} s: {obs.samples} samples; setup {obs.setup_s:.6f} s")
    for k, v in sorted(obs.sections.items(), key=lambda kv: -kv[1]):
        print(f"  section {k}: {v:.6f} s ({100 * v / obs.window_s:.3f}% of the window), "
              f"{out['counts'].get(k, 0)} entries")
    for job, e, off1, dense, max_abs in check.per_epoch:
        print(f"  checked job {job} epoch {e}: off1 {off1:.6f}% dense {dense:.6f}% "
              f"max_abs {max_abs}")
    failed = {r.job.index for r in results if r.error} | check.failed_jobs
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = read_metric(m, obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(device_info, memory_peak_bytes=out["peak"])
    line = {"correct": check.passed and not failed, "attempted": len(results),
            "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and obs.trace is not None:
        t = obs.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        top = lambda d: [[k[:160], v]  # noqa: E731
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        line["breakdown"] = {"device_ops": top(t.op_seconds), "idle_gaps": top(t.idle_by_range)}
        print(f"trace: window {t.window_s:.6f} s, device busy {t.busy_s:.6f} s, "
              f"{len(t.kp_calls)} kp calls, {t.conv_calls} conv1d calls")
    line["checks"] = {k: {"value": v, "limit": check.limits.get(k)}
                      for k, v in check.readings.items()}
    return line


def main(argv: list, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"{cell.name} needs {cell.chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()}\n")
        return 3
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: imported at "
          f"{t_torch - t0:.6f} s, the card found at {time.perf_counter() - t0:.6f} s")
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    line = report(cell, out, bool(args.trace), info)
    found = blocked_modules()
    if found:
        sys.stderr.write(f"modules of JAX or the JAX package were loaded: {found}\n")
        return 4
    print(json.dumps(line), flush=True)
    for k, c in line["checks"].items():
        sys.stderr.write(f"check {k} {c['value']} limit {c['limit']}\n")
    return 0
