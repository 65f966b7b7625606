"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
1. the card (nvidia-smi name and power limit); a CUDA device is required;
2. build of the CUDA kernel csrc/synth_kp_v5.cu from this checkout;
3. the kernel against its plain PyTorch version on the card, at B=8
   epochs x 200 rows x 1300 samples, C=8 and C=16 channels, on seeded
   synthetic operands (adversarial cases included) and on one block of
   the fixture scene, held to the engine bar (>= 99.9% of int16 values
   identical, every difference <= 1000);
4. the main path through the port's CLI (file sink, fixture nav file,
   3 s at Boston): the kernel launch count rose, the file holds every
   epoch, and PCPS acquisition finds every active PRN at its Doppler
   while absent PRNs stay at the noise floor;
5. timings with CUDA events (kernel vs plain version, median of 25
   samples of 10 back-to-back calls, after warm-up) and the end-to-end file-sink rate of a 30 s run (3 runs),
   each with its stage split.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "galileo_sdr_sim_tpu_torch"
NAV = ROOT / "tests" / "data" / "obs_fixture_nav.rnx"
B, N_K = 8, 200
ABSENT_PRNS = (1, 2, 3)  # below the horizon in the fixture scene
MIN_METRIC = 8.0
E2E_RUNS = 3  # 30 s scenario runs through the CLI's build_run


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 25, per: int = 10, warmup: int = 3) -> float:
    """Median over n samples of the device time of one call, each sample
    `per` back-to-back calls between two CUDA events (so the host's
    launch overhead hides behind the queued work), divided by `per`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per)
    return float(np.median(times))


def main() -> int:
    # --- 1. the card -----------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs one GPU")
    check((PKG / "csrc").is_dir() and NAV.is_file(),
          f"{ROOT} is not a checkout of the repository (no port sources or nav file)")
    gpu = card()
    print(f"card: {gpu}")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from galileo_sdr_sim_tpu.rx_track import acquire, iq_to_complex
    from galileo_sdr_sim_tpu_torch import cli
    from galileo_sdr_sim_tpu_torch.harness import (
        CASES, FIXTURE_LLH, FIXTURE_START, engine_bar, fixture_engine, synthetic_kp_inputs,
    )
    from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda
    from galileo_sdr_sim_tpu_torch.ops.synth_kp import prepare_kp_inputs, synth_kp_packed_ref

    # --- 2. build --------------------------------------------------------
    _, built = synth_kp_cuda.library()
    print(f"build: {built.path.name} in {built.seconds:.2f} s (fmad={synth_kp_cuda.FMAD})")
    print(built.log.strip())

    # --- 3. kernel vs plain version on the card --------------------------
    worst = 0
    for C in (8, 16):
        for case in CASES:
            inputs = synthetic_kp_inputs(B, C, 100 + C, case, dev)
            got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
            ref = synth_kp_packed_ref(inputs, N_K)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (B, N_K, 1300), f"kernel output shape {tuple(got.shape)}")
            bar = engine_bar(got.cpu().numpy(), ref.cpu().numpy())
            print(f"compare C={C} {case}: match={bar['match']:.6f} max_abs_err={bar['max_abs_err']}")
            check(bar["ok"], f"engine bar at C={C} {case}: {bar}")
            worst = max(worst, bar["max_abs_err"])
    batch = next(fixture_engine(NAV, 1.0).batches(B))
    inputs = prepare_kp_inputs(batch, N_K * 1300, pad_epochs=B, device=dev)
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K).cpu().numpy()
    ref = synth_kp_packed_ref(inputs, N_K).cpu().numpy()
    bar = engine_bar(got, ref)
    active = int((batch.prn > 0).sum())
    print(f"compare fixture block (C={inputs['cp0'].shape[1]}, {active} active): "
          f"match={bar['match']:.6f} max_abs_err={bar['max_abs_err']}")
    check(bar["ok"], f"engine bar on the fixture block: {bar}")
    check(np.count_nonzero(got) > 0.9 * got.size, "fixture block is mostly silent")
    worst = max(worst, bar["max_abs_err"])

    llh = ",".join(str(v) for v in FIXTURE_LLH)
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as tmp:
        # --- 4. the main path through the CLI ----------------------------
        out = Path(tmp) / "smoke.ishort"
        argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "3", "-t", FIXTURE_START,
                "-l", llh, "-o", str(out)]
        synth_kp_cuda.launch_count = 0
        rc = cli.main(argv)
        launches = synth_kp_cuda.launch_count
        print(f"main path: rc={rc} kernel launches={launches}")
        check(rc == 0, f"cli.main returned {rc}")
        check(launches > 0, "the main path did not launch the CUDA kernel")
        epochs = len(fixture_engine(NAV, 3.0))
        size = out.stat().st_size
        print(f"main path: {size} bytes for {epochs} epochs")
        check(size == epochs * 260000 * 4, f"file holds {size} bytes, want {epochs} x 260000 x 4")
        x = iq_to_complex(np.fromfile(out, dtype=np.int16, count=2 * 15600))
        check(bool(np.all(np.isfinite(x))), "non-finite samples")
        first = next(fixture_engine(NAV, 1.0).batches(B))
        for c in np.flatnonzero(first.prn > 0):
            prn, f_carr = int(first.prn[c]), float(first.f_carr[0, c])
            a = acquire(x, prn)
            print(f"acquire PRN {prn:2d}: metric {a.metric:6.1f} doppler {a.doppler:7.0f} "
                  f"(engine {f_carr:8.1f})")
            check(a.metric >= MIN_METRIC, f"PRN {prn} not acquired")
            check(abs(a.doppler - f_carr) <= 100.0, f"PRN {prn} at the wrong Doppler")
        for prn in ABSENT_PRNS:
            check(prn not in first.prn, f"control PRN {prn} is in the scene")
            a = acquire(x, prn)
            print(f"acquire absent PRN {prn:2d}: metric {a.metric:6.1f}")
            check(a.metric < MIN_METRIC, f"false acquisition of absent PRN {prn}")

        # --- 5. timings --------------------------------------------------
        times = {}
        for C in (8, 16):
            inputs = synthetic_kp_inputs(B, C, 100 + C, "random", dev)
            plain = median_ms(lambda: synth_kp_packed_ref(inputs, N_K))
            kern = median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            times[C] = (kern, plain)
            print(f"time B={B} n_k={N_K} C={C}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                  f"({gpu})")
        rates = []
        for rep in range(E2E_RUNS):
            e2e_out = Path(tmp) / f"e2e{rep}.ishort"
            args = cli.build_torch_parser().parse_args(
                ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "30", "-t", FIXTURE_START,
                 "-l", llh, "-o", str(e2e_out)]
            )
            run = cli.build_run(args)
            e2e_launches = synth_kp_cuda.launch_count
            try:
                t0 = time.perf_counter()
                stats = run.synth.run()
                wall = time.perf_counter() - t0
            finally:
                run.close()
            e2e_launches = synth_kp_cuda.launch_count - e2e_launches
            check(e2e_out.stat().st_size == stats.samples * 4, "e2e file size")
            e2e_out.unlink()
            rates.append(stats.samples / wall)
            # kernel time per launch (timed above, C = 8) x launches / wall
            busy = e2e_launches * times[8][0] / 1e3 / wall
            print(f"e2e file sink run {rep}: {stats.epochs} epochs, {stats.samples} samples "
                  f"in {wall:.3f} s = {rates[-1]:.0f} samples/s, {e2e_launches} kernel "
                  f"launches, device busy in the kernel ~{busy:.2%} ({gpu})")
            print(stats.stage_report())
        print(f"e2e file sink median of {E2E_RUNS}: {np.median(rates):.0f} samples/s ({gpu})")

    kern8, plain8 = times[8]
    print(json.dumps({"kernels": [{
        "name": "synth_kp_v5",
        "route": "cuda",
        "source": "galileo_sdr_sim_tpu_torch/csrc/synth_kp_v5.cu",
        "replaces": "galileo_sdr_sim_tpu/ops/synth_kp_pallas.py:74",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kern8,
        "plain_ms": plain8,
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
