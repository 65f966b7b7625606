"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

JAX and the JAX package `galileo_sdr_sim_tpu` are blocked from import
before the port is imported: the port stands alone.

Phases, each printed on its own lines; any failure exits non-zero:
1. the card (nvidia-smi name and power limit); a CUDA device is required;
2. build, in parallel, of csrc/synth_kp_v5.cu (its prologue kernel and
   the six instantiations of its main kernel: sine-BOC or CBOC, without
   or with per-channel gain, and the f32 emit of sine-BOC and CBOC, all
   in the TPU kernel's K-vectorised main loop), of
   csrc/gather_probe.cu and of csrc/launch_floor.cu (the empty kernel
   that times a launch), from this checkout; each kernel's registers and
   spills (ptxas) and SASS instruction classes (cuobjdump), whole and in
   its main loop, which must hold no int<->float conversion; then the
   same-bits guard: every instantiation reproduces the digests of
   tests/data/torch_kp_digests.json ("digests: N of N equal"), and
   one-epoch blocks (live mode's grid) equal the epochs of an
   eight-epoch block;
3. each instantiation against its plain PyTorch version on the card, at
   B=8 epochs x 200 rows x 1300 samples, C = 2, 8 and 16 channels, on
   seeded synthetic operands (adversarial cases included) and on one
   block of the fixture scene (its CBOC version for the CBOC
   instantiations), held to the engine bar (>= 99.9% of int16 values
   identical, every difference <= 1000; `cboc_bar`, >= 99.8%, for
   CBOC); the int16 view against its plain version; the prologue kernel
   against `kp_planes_ref` (integer planes exact, cos/sin within 2^-22
   for the K factor and 2^-17 for the p factor);
4. the kernel's f32 emit (sine-BOC and CBOC) against its plain version
   on the same operands as in 3, plus one uncompacted fixture block
   (C = 16): its truncation held to the engine bar (`cboc_bar`) and
   bit-equal to the packed kernel's output;
5. the main paths through the port's CLI (file sink, fixture nav file,
   at Boston), each with the launch counts set to 0 just before it and
   read just after: the default run (3 s), `--model cboc` and
   `--apply-gain` (1 s each), `--model cboc --apply-gain` (3 s) and
   `--bandlimit --apply-gain` (3 s, 12 launches a block).  Each run's
   instantiation was launched, the file holds every epoch, and PCPS
   acquisition finds every active PRN at its Doppler while absent PRNs
   stay at the noise floor (metric 8; 6, the level of the JAX package's
   band-limited acquisition test, where the run weights channels by
   their gain, whose weakest visible one sits at 0.43 of the strongest,
   or is band-limited); then the gather probe's `main()` (seven
   probes, each CORRECT);
6. the multi-process paths: the CLI in distributed mode as one NCCL
   process (3 s; only the f32 instantiation runs, once a block; the file
   is byte-identical to the default run's and acquires); the sharded
   CBOC path (`mesh.synth_batch_kp_sharded`, world of one) against the
   packed CBOC kernel; two ranks sharing the card over gloo on CUDA
   tensors (tests/_torch_dist_worker.py, mode "card"): 3 s over the
   (sat 2, time 1) mesh, 16 uncompacted channels, 8 a rank, and over a
   (sat 1, time 2) mesh, each held to the default run's file by the
   psum bar (>= 99.9% identical, no sample off by more than 1 LSB), the
   first acquired;
7. timings with CUDA events (kernel vs plain version for each
   instantiation and the f32 emit at B = 8, each instantiation at B = 1;
   the pair of launches of a call, the prologue kernel alone, the
   wrapper's host time a call and the launch floors, at B = 8 with
   C = 2, 8 and 16 and at B = 1; median of 25 samples of 10 back-to-back
   calls queued behind a sleep kernel, after warm-up; the gather kernel
   beside its plain version, `torch.take_along_dim` and its launch floor
   on the seven probe shapes; the band-limit filter per block;
   the all-reduce of one block's float32 partial, NCCL in one rank and
   gloo in two), the end-to-end file-sink rate of a 30 s default run and
   of a 10 s `--bandlimit` run (3 runs each), of a 10 s one-process
   distributed run (3 runs) and of a 10 s two-rank run, each with its
   stage split, and the device time of a 5 s `--bandlimit` run under
   torch.profiler;
8. the acceptance tier and the stream's modes, at full width (B = 8,
   the fixture scene's 7 satellites), each run with the counts set to 0
   just before it and read just after: 19 s from 23:30:18 (harness
   PVT_START) through cli.main, then the in-repo receiver's PVT fix
   (harness.pvt_fix) from the file, >= 5 satellites within 15 m and the
   receive time within 1e-5 s; the same with --bandlimit (12 launches
   a block through the int16 view), >= 5 satellites within 20 m;
   --pipeline-depth 3, byte-identical to the depth-1 file with the same
   launches; a crash at depth 3 (a snapshot every 2-epoch block, the
   sink stops the run after 3 blocks) and a resume by a fresh executor,
   together byte-identical to one depth-1 run of the 2 s scene; the
   device-resident drain (harness.AbsSumSink sums |x| on the card per
   block) equal to the host drain's sums, at depth 1 and 3, every block
   a CUDA tensor; live mode at B = 1 (harness.live_pickup): a UDP
   position update sent while block 1 drains reaches block 3's samples;
   the file-sink rate of 30 s runs at depth 1 and 3, in turns, three
   runs each, median, min and max, with the stage split;
9. the direct fallback through the CLI: the jump scene (a user-motion
   file, 15 s at the fixture site, then 1370 km south of it; 32 s)
   through cli.main on the card (no --device: the CLI takes the card) and
   with --device cpu (the CLI as a second process, started beside phase
   8).  The card's run launches the kernel for every block but those
   with an epoch outside the code-Doppler envelope, of which there is at
   least one; its file holds every epoch; its kp blocks and its fallback
   blocks each meet the engine bar against the CPU's file (both routes
   are float-carrier engines); the PRNs allocated after the jump acquire
   at their Doppler in the last block; and the direct engine's device
   time for one fallback block (CUDA events).
The JSON summary of the kernels (with each one's bound: the larger of
its float32 operations over the card's FP32 peak and its bytes over the
HBM rate, see `kp_bound`, `planes_bound` and `gather_bytes`; and its
launch floor `floor_ms`: empty kernels of the same grids and block
sizes, timed the same way) and the card's name and power limit are the
two lines before the last; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import os
import socket
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
DIST_WORKER = ROOT / "tests" / "_torch_dist_worker.py"
DIGESTS = ROOT / "tests" / "data" / "torch_kp_digests.json"
B, N_K = 8, 200
NSAMP = N_K * 1300
ABSENT_PRNS = (1, 2, 3)  # below the horizon in the fixture scene
MIN_METRIC = 8.0
# runs with --apply-gain (PRN 33 weighs 0.43 of the strongest channel and
# reads ~7.9) and band-limited runs: tests/test_bandlimit.py's level
MIN_METRIC_WEAK = 6.0
E2E_RUNS = 3  # scenario runs through the CLI's build_run
RANKS_TIMEOUT_S = 600  # the two-rank phase, both ranks together
JUMP_CPU_TIMEOUT_S = 600  # the jump scene's --device cpu run, beside phase 8
# channel counts of the synthetic checks: tools/probe_vec_kt.py's, from
# few channels to all 16 slots
KP_CS = (2, 8, 16)
# NVIDIA H100 SXM peaks (data sheet, at the 700 W limit): FP32 outside the
# tensor cores, and HBM3
FP32_PEAK = 67e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# float32 operations of the kp kernel, counted from the main loop of
# csrc/synth_kp_v5.cu (an FMA counts 2; integer bit ops and int8 ->
# float conversions are not counted, nor are the per-(c, p) prologue and
# the K-factor table, under 2% of the rest): per (channel, sample) 29 --
# t_kp 2, floor 1, chip_b and chip_c 6, bsel 3, d_val and s_val 4, the
# mix 3, the carrier product 6, the two accumulations 4 -- plus 5 under
# CBOC (frac, j6 and the two weight products) and 1 with gain; per
# (channel, kap, p) 26 (six +-1 symbol selects 12; d_lo, d_df, s_lo,
# s_df 14)
KP_OPS_SAMPLE, KP_OPS_CBOC, KP_OPS_GAIN, KP_OPS_KAP = 29, 5, 1, 26


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def psum_bar(got: np.ndarray, ref: np.ndarray) -> dict:
    """Sharded against single-process int16 output: the all-reduce
    reassociates the float32 channel sum (JAX package's PSUM_* bounds)."""
    from galileo_sdr_sim_tpu_torch.parallel.distributed import (
        PSUM_MAX_LSB, PSUM_SAMPLE_IDENTITY_BOUND,
    )

    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    match, max_err = float((diff == 0).mean()), int(diff.max())
    return {"match": match, "max_abs_err": max_err,
            "ok": got.shape == ref.shape and match >= PSUM_SAMPLE_IDENTITY_BOUND
            and max_err <= PSUM_MAX_LSB}


def bound(ops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the least time of the work on the card, the
    larger of its operations over the FP32 peak and its bytes over the
    HBM rate."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kp_bound(inputs: dict, n_k: int, f32: bool = False) -> tuple:
    """`bound` of one kp kernel call on these operands: KP_OPS_* float32
    operations; each (B, C) operand read once, the 32 code-table taps each
    (b, c, p) selects (what the table lookups of this call need), and the
    output written once (int32 packed, or float2 under f32)."""
    from galileo_sdr_sim_tpu_torch.ops.synth_kp import (
        GAIN_OPERAND, P_GRID, SCALAR_OPERANDS, W_PACK,
    )

    B, C = inputs["cp0"].shape
    per_sample = (KP_OPS_SAMPLE + KP_OPS_CBOC * ("cboc_ab" in inputs)
                  + KP_OPS_GAIN * (GAIN_OPERAND in inputs))
    ops = B * C * n_k * P_GRID * per_sample + B * C * (n_k // 8) * P_GRID * KP_OPS_KAP
    operands = [k for k in (*SCALAR_OPERANDS, GAIN_OPERAND) if k in inputs]
    nbytes = (sum(inputs[k].numel() * inputs[k].element_size() for k in operands)
              + B * C * P_GRID * W_PACK + B * n_k * P_GRID * (8 if f32 else 4))
    return bound(ops, nbytes)


def planes_bound(inputs: dict, n_k: int) -> tuple:
    """`bound` of one prologue-kernel call: its bytes over the HBM rate.
    The nine (B, C) operands it reads, the 32 code-table taps each
    (b, c, p) selects, and the planes written once (52 bytes a (b, c, p),
    8 bytes a (b, c, K))."""
    from galileo_sdr_sim_tpu_torch.ops.synth_kp import P_GRID, W_PACK
    from galileo_sdr_sim_tpu_torch.ops.synth_kp_cuda import PLANE_OPERANDS

    B, C = inputs["cp0"].shape
    nbytes = (sum(inputs[k].numel() * inputs[k].element_size() for k in PLANE_OPERANDS)
              + B * C * P_GRID * (W_PACK + 52) + B * C * n_k * 8)
    return bound(0, nbytes)


def gather_bytes(idx: torch.Tensor, axis: int) -> int:
    """Bytes one take_along_axis call must move on these indices: each
    table element the indices reach read once (counted on this run's
    indices), the int32 indices read and the int32 output written."""
    rows, cols = idx.shape
    i = idx.long()
    if axis == 0:
        flat = i * cols + torch.arange(cols, device=idx.device)
    else:
        flat = torch.arange(rows, device=idx.device)[:, None] * cols + i
    return (int(torch.unique(flat).numel()) + 2 * idx.numel()) * 4


def main() -> int:
    # --- 1. the card -----------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs one GPU")
    check((PKG / "csrc").is_dir() and NAV.is_file(),
          f"{ROOT} is not a checkout of the repository (no port sources or nav file)")
    gpu = card()
    print(f"card: {gpu}")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    import torch.distributed as dist

    from galileo_sdr_sim_tpu_torch._block_reference import install

    install()  # JAX and the JAX package, before the rest of the port loads
    from galileo_sdr_sim_tpu_torch import cli
    from galileo_sdr_sim_tpu_torch.harness import (
        CASES, FIXTURE_LLH, FIXTURE_START, JUMP_SECONDS, KP_INSTANTIATIONS, PVT_SECONDS, PVT_START,
        AbsSumSink, acquire_block, cboc_bar, compare_jump_files, engine_bar, fixture_engine,
        free_udp_ports, jump_scene_blocks, kp_digests, live_pickup, pvt_fix, synthetic_kp_inputs,
        write_jump_motion,
    )
    from galileo_sdr_sim_tpu_torch.io.sinks import Sink
    from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
    from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3
    from galileo_sdr_sim_tpu_torch.scenario import (
        PositionProvider, ScenarioEngine, scenario_start_time,
    )
    from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
    from galileo_sdr_sim_tpu_torch.models.e1 import E1_OS
    from galileo_sdr_sim_tpu_torch.ops import bandlimit, gather_probe, measure, synth_kp_cuda
    from galileo_sdr_sim_tpu_torch.ops.measure import floor_ms, host_ms, median_ms
    from galileo_sdr_sim_tpu_torch.ops.synth_kp_cuda import PLANES
    from galileo_sdr_sim_tpu_torch.ops.synth_kp import (
        kp_planes_ref, mu_in_envelope, pack_iq, packed_to_iq16, prepare_kp_inputs,
        synth_kp_accum_ref, synth_kp_int16_ref, synth_kp_packed_ref,
    )
    from galileo_sdr_sim_tpu_torch.parallel import distributed as D
    from galileo_sdr_sim_tpu_torch.parallel import mesh as M
    from galileo_sdr_sim_tpu_torch.profiling import Timer
    from galileo_sdr_sim_tpu_torch.rx_track import acquire, iq_to_complex

    # --- 2. build, one nvcc a source, all started together ----------------
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(synth_kp_cuda.library), pool.submit(gather_probe.library),
                  pool.submit(measure.floor_library)]
        (_, built), (_, gbuilt), (_, fbuilt) = (f.result() for f in builds)
    print(f"build: {built.path.name} in {built.seconds:.2f} s (fmad={synth_kp_cuda.FMAD}), "
          f"{gbuilt.path.name} in {gbuilt.seconds:.2f} s, {fbuilt.path.name} in "
          f"{fbuilt.seconds:.2f} s, {time.perf_counter() - t0:.2f} s wall")
    print(built.log.strip())
    print(gbuilt.log.strip())
    # what the compiler made of each instantiation: registers and spills,
    # and the SASS instruction classes of the kernel and of its main loop,
    # which must hold no int<->float conversion
    for fn, line in measure.ptxas_summary(built.log).items():
        print(f"ptxas {measure.kp_function(fn)}: {line}")
    for fn, counts in measure.sass_counts(built.path).items():
        name = measure.kp_function(fn)
        for part in ("kernel", "loop"):
            print(f"sass {name} {part}: " + " ".join(f"{k}={v}" for k, v in counts[part].items()))
        conv = {k: counts["loop"][k] for k in measure.CONVERSIONS if counts["loop"][k]}
        check(name not in KP_INSTANTIATIONS or (counts["loop"]["FFMA"] > 0 and not conv),
              f"{name}: main loop not found or converts ({conv})")

    # --- the same-bits guard: every instantiation's recorded digests -----
    recorded = json.loads(DIGESTS.read_text())
    print(f"digests recorded with {recorded['made_with']}")
    n_same = n_all = 0
    for name in KP_INSTANTIATIONS:
        got = kp_digests(synth_kp_cuda, name, NAV, dev)
        want = recorded["digests"][name]
        check(set(got) == set(want), f"{name}: digest cases {sorted(got)} vs {sorted(want)}")
        for key in want:
            if got[key] != want[key]:
                print(f"digest differs: {name} {key}")
        n_same += sum(got[key] == want[key] for key in want)
        n_all += len(want)
    print(f"digests: {n_same} of {n_all} equal")
    check(n_same == n_all, "the kernel does not reproduce the recorded digests")
    # live mode's one-epoch blocks (K chunks of 8 rows, 275 blocks) give
    # the epochs of an eight-epoch block (chunks of 40) bit for bit
    for name, (variant, f32) in KP_INSTANTIATIONS.items():
        inputs = synthetic_kp_inputs(B, 8, 108, "edges", dev, **variant)
        wrapper = synth_kp_cuda.synth_kp_accum if f32 else synth_kp_cuda.synth_kp_packed
        whole = wrapper(inputs, N_K)
        same = all(torch.equal(wrapper({k: v[b:b + 1].contiguous() if v.dim() == 2 else v
                                        for k, v in inputs.items()}, N_K), whole[b:b + 1])
                   for b in range(B))
        print(f"{name}: one-epoch blocks (k_chunk {synth_kp_cuda.k_chunk(1, 8)}) equal the "
              f"eight-epoch block (k_chunk {synth_kp_cuda.k_chunk(B, 8)}): {same}")
        check(same, f"{name}: one-epoch blocks differ")

    # --- 3. each instantiation vs its plain version on the card ----------
    # packed instantiation -> its operand variant; f32 one -> whether CBOC
    VARIANTS = {name: v for name, (v, f32) in KP_INSTANTIATIONS.items() if not f32}
    F32 = {name: bool(v) for name, (v, f32) in KP_INSTANTIATIONS.items() if f32}
    worst = dict.fromkeys(VARIANTS, 0)
    for name, variant in VARIANTS.items():
        bar_fn = cboc_bar if "cboc" in variant else engine_bar
        for C in KP_CS:
            for case in CASES:
                inputs = synthetic_kp_inputs(B, C, 100 + C, case, dev, **variant)
                check(synth_kp_cuda.instantiation(inputs) == name, f"{name}: operands select "
                      f"{synth_kp_cuda.instantiation(inputs)}")
                got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
                ref = synth_kp_packed_ref(inputs, N_K)
                torch.cuda.synchronize()
                check(tuple(got.shape) == (B, N_K, 1300), f"kernel output shape {tuple(got.shape)}")
                bar = bar_fn(got, ref)
                print(f"compare {name} C={C} {case}: match={bar['match']:.6f} "
                      f"max_abs_err={bar['max_abs_err']}")
                check(bar["ok"], f"{name} at C={C} {case}: {bar}")
                worst[name] = max(worst[name], bar["max_abs_err"])
        model = E1_CBOC if variant.get("cboc") else E1_OS
        batch = next(fixture_engine(NAV, 1.0, model).batches(B))
        inputs = prepare_kp_inputs(batch, N_K * 1300, pad_epochs=B, device=dev,
                                   apply_gain=bool(variant.get("gain")))
        check(synth_kp_cuda.instantiation(inputs) == name, f"{name}: fixture operands")
        got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
        ref = synth_kp_packed_ref(inputs, N_K)
        bar = bar_fn(got, ref)
        active = int((batch.prn > 0).sum())
        print(f"compare {name} fixture block ({model.name}, C={inputs['cp0'].shape[1]}, "
              f"{active} active): match={bar['match']:.6f} max_abs_err={bar['max_abs_err']}")
        check(bar["ok"], f"{name} on the fixture block: {bar}")
        check(np.count_nonzero(got.cpu().numpy()) > 0.9 * got.numel(), "fixture block is mostly silent")
        worst[name] = max(worst[name], bar["max_abs_err"])
    inputs16 = synthetic_kp_inputs(B, 8, 108, "random", dev, cboc=True, gain=True)
    got16 = synth_kp_cuda.synth_kp_int16(inputs16, N_K)
    check(got16.dtype == torch.int16 and tuple(got16.shape) == (B, 2 * N_K * 1300),
          f"int16 view {got16.dtype}{tuple(got16.shape)}")
    bar = cboc_bar(got16, synth_kp_int16_ref(inputs16, N_K))
    print(f"compare int16 view (cboc_gain, C=8): match={bar['match']:.6f} "
          f"max_abs_err={bar['max_abs_err']}")
    check(bar["ok"], f"int16 view: {bar}")
    worst_int16 = bar["max_abs_err"]

    # the prologue kernel against kp_planes_ref: the integer planes, psi
    # and w8 exactly, cos and sin of the K factor within 2^-22 (cosf and
    # sinf against float64 rounded once), of the p factor within 2^-17
    # (the kernel's FMA in carr0 + fc*p moves the phase by up to an ulp)
    batch = next(fixture_engine(NAV, 1.0).batches(B))
    plane_cases = [(C, "random", synthetic_kp_inputs(B, C, 100 + C, "random", dev)) for C in KP_CS]
    plane_cases.append((8, "fixture block", prepare_kp_inputs(batch, NSAMP, pad_epochs=B, device=dev)))
    worst_planes = 0.0
    for C, case, inputs in plane_cases:
        got = synth_kp_cuda.kp_planes(inputs, N_K)
        ref = kp_planes_ref(inputs, N_K)
        exact = all(torch.equal(got[k], ref[k]) for k in ("chip", "bits")) and torch.equal(
            got["plf"][..., :2], ref["plf"][..., :2])
        err_p = float((got["plf"][..., 2:] - ref["plf"][..., 2:]).abs().max())
        err_k = float((got["cisk"] - ref["cisk"]).abs().max())
        print(f"compare {PLANES} C={C} {case}: integer planes, psi, w8 equal={exact} "
              f"cos/sin max_abs_err p {err_p:.3g} K {err_k:.3g}")
        check(exact and err_p <= 2.0**-17 and err_k <= 2.0**-22, f"{PLANES} at C={C} {case}")
        worst_planes = max(worst_planes, err_p, err_k)

    # --- 4. the f32 emit vs its plain version and the packed store --------
    for name, cboc in F32.items():
        bar_fn = cboc_bar if cboc else engine_bar
        model = E1_CBOC if cboc else E1_OS
        batch = next(fixture_engine(NAV, 1.0, model).batches(B))
        cases = [(C, case, synthetic_kp_inputs(B, C, 100 + C, case, dev, cboc=cboc))
                 for C in KP_CS for case in CASES]
        cases.append((16, "fixture block uncompacted",
                      prepare_kp_inputs(batch, NSAMP, pad_epochs=B, device=dev, compact=False)))
        worst[name] = 0
        for C, case, inputs in cases:
            check(synth_kp_cuda.instantiation(inputs, f32=True) == name, f"{name}: operands")
            got = synth_kp_cuda.synth_kp_accum(inputs, N_K)
            ref = synth_kp_accum_ref(inputs, N_K)
            packed = synth_kp_cuda.synth_kp_packed(inputs, N_K)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and tuple(got.shape) == (B, NSAMP, 2),
                  f"f32 output {got.dtype}{tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name} C={C} {case}: non-finite values")
            bar = bar_fn(pack_iq(got), pack_iq(ref))
            same = torch.equal(pack_iq(got), packed)
            print(f"compare {name} C={C} {case}: match={bar['match']:.6f} "
                  f"max_abs_err={bar['max_abs_err']} trunc bit-equal to packed={same}")
            check(bar["ok"], f"{name} at C={C} {case}: {bar}")
            check(same, f"{name} at C={C} {case}: truncation differs from the packed store")
            worst[name] = max(worst[name], bar["max_abs_err"])

    llh = ",".join(str(v) for v in FIXTURE_LLH)
    nav_fx = read_rinex_v3(str(NAV))
    pvt_g0 = scenario_start_time(nav_fx, cli._parse_time(PVT_START))
    launches = dict.fromkeys((*VARIANTS, PLANES), 0)
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as tmp:
        # --- 5. the main paths through the CLI ----------------------------
        def acquire_file(out: Path, label: str, model, min_metric: float) -> None:
            """PCPS acquisition of the file's first 6 ms: every active PRN
            of the scene at its Doppler, the absent ones below the bar."""
            x = iq_to_complex(np.fromfile(out, dtype=np.int16, count=2 * 15600))
            check(bool(np.all(np.isfinite(x))), "non-finite samples")
            first = next(fixture_engine(NAV, 1.0, model).batches(B))
            for c in np.flatnonzero(first.prn > 0):
                prn, f_carr = int(first.prn[c]), float(first.f_carr[0, c])
                a = acquire(x, prn)
                print(f"acquire {label} PRN {prn:2d}: metric {a.metric:6.1f} doppler "
                      f"{a.doppler:7.0f} (engine {f_carr:8.1f})")
                check(a.metric >= min_metric, f"{label}: PRN {prn} not acquired")
                check(abs(a.doppler - f_carr) <= 100.0, f"{label}: PRN {prn} at the wrong Doppler")
            for prn in ABSENT_PRNS:
                check(prn not in first.prn, f"control PRN {prn} is in the scene")
                a = acquire(x, prn)
                print(f"acquire {label} absent PRN {prn:2d}: metric {a.metric:6.1f}")
                check(a.metric < min_metric, f"{label}: false acquisition of absent PRN {prn}")

        def main_path(options: list, duration: float, name: str, min_metric: float,
                      blocks_x: int = 1, env: dict | None = None, keep: str = "") -> dict:
            """Drive cli.main once with the counts reset just before and
            read just after, with `env` set for the call; check the file
            and acquire it; keep it as tmp/`keep` when named."""
            out = Path(tmp) / (keep or "smoke.ishort")
            argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(duration),
                    "-t", FIXTURE_START, "-l", llh, "-o", str(out), *options]
            os.environ.update(env or {})
            try:
                synth_kp_cuda.reset_counts()
                rc = cli.main(argv)
                counts = dict(synth_kp_cuda.launch_counts)
                int16 = synth_kp_cuda.int16_launch_count
                planes = counts.pop(PLANES)
            finally:
                for key in env or {}:
                    del os.environ[key]
            label = " ".join(options) or "default"
            if env:
                label += " distributed"
            print(f"main path {label}: rc={rc} launches={counts} prologue={planes} "
                  f"int16 views={int16}")
            check(rc == 0, f"cli.main {label} returned {rc}")
            model = E1_CBOC if "--model" in options or "--bandlimit" in options else E1_OS
            epochs = len(fixture_engine(NAV, duration, model))
            n_blocks = -(-epochs // B)
            check(counts[name] == n_blocks * blocks_x,
                  f"{label}: {counts[name]} launches of {name}, want {n_blocks * blocks_x}")
            check(sum(counts.values()) == counts[name], f"{label}: other instantiations ran")
            check(planes == counts[name], f"{label}: {planes} prologue launches for {counts[name]}")
            size = out.stat().st_size
            print(f"main path {label}: {size} bytes for {epochs} epochs")
            check(size == epochs * NSAMP * 4, f"file holds {size} bytes, want {epochs} x {NSAMP} x 4")
            acquire_file(out, label, model, min_metric)
            if not keep:
                out.unlink()
            launches[PLANES] += planes
            return {"counts": counts, "int16": int16}

        launches["synth_kp_v5"] = main_path(
            [], 3, "synth_kp_v5", MIN_METRIC, keep="default.ishort")["counts"]["synth_kp_v5"]
        default_iq = np.fromfile(Path(tmp) / "default.ishort", dtype=np.int16)
        launches["synth_kp_v5_cboc"] = main_path(
            ["--model", "cboc"], 1, "synth_kp_v5_cboc", MIN_METRIC)["counts"]["synth_kp_v5_cboc"]
        launches["synth_kp_v5_gain"] = main_path(
            ["--apply-gain"], 1, "synth_kp_v5_gain", MIN_METRIC_WEAK)["counts"]["synth_kp_v5_gain"]
        launches["synth_kp_v5_cboc_gain"] = main_path(
            ["--model", "cboc", "--apply-gain"], 3, "synth_kp_v5_cboc_gain", MIN_METRIC_WEAK
        )["counts"]["synth_kp_v5_cboc_gain"]
        bl = main_path(["--bandlimit", "--apply-gain"], 3, "synth_kp_v5_cboc_gain",
                       MIN_METRIC_WEAK, blocks_x=bandlimit.OS)
        launches["synth_kp_v5_cboc_gain"] += bl["counts"]["synth_kp_v5_cboc_gain"]
        check(bl["int16"] == bl["counts"]["synth_kp_v5_cboc_gain"],
              "the band-limited run did not go through the int16 view")
        launches_int16 = bl["int16"]

        # the gather probe's main(): seven probes, each CORRECT
        gather_probe.launch_count = 0
        rc = gather_probe.main([])
        launches["gather_probe"] = gather_probe.launch_count
        print(f"main path gather probe: rc={rc} launches={launches['gather_probe']}")
        check(rc == 0, "the gather probe found a wrong result")
        check(launches["gather_probe"] == len(gather_probe.PROBES), "gather probe launches")

        # --- 6. the multi-process paths ------------------------------------
        # the CLI in distributed mode, one NCCL process: every block through
        # the f32 emit and the (one-rank) all-reduce
        dist_env = {D.ENV_COORD: f"127.0.0.1:{free_port()}", D.ENV_NPROC: "1", D.ENV_PID: "0"}
        launches["synth_kp_v5_f32"] = main_path(
            [], 3, "synth_kp_v5_f32", MIN_METRIC, env=dist_env, keep="dist1.ishort"
        )["counts"]["synth_kp_v5_f32"]
        check(not dist.is_initialized(), "the CLI left its process group initialized")
        same = np.array_equal(np.fromfile(Path(tmp) / "dist1.ishort", dtype=np.int16), default_iq)
        print(f"distributed one-process file byte-identical to the default run's: {same}")
        check(same, "the one-process distributed file differs from the default run's")

        # the sharded CBOC path (replicated weights) in a world of one, the
        # NCCL all-reduce per block, and the distributed end-to-end rate
        D.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
        try:
            mesh = D.global_mesh("cuda")
            check(mesh.shape == {"sat": 1, "time": 1}, f"mesh {mesh.shape}")
            synth_kp_cuda.reset_counts()
            sharded = [M.synth_batch_kp_sharded(batch, mesh)
                       for batch in fixture_engine(NAV, 3.0, E1_CBOC).batches(B)]
            counts = dict(synth_kp_cuda.launch_counts)
            print(f"mesh path cboc: launches={counts}")
            n_blocks = len(sharded)
            check(counts.pop(PLANES) == n_blocks, f"mesh path cboc: prologue launches {counts}")
            check(counts["synth_kp_v5_cboc_f32"] == n_blocks and sum(counts.values()) == n_blocks,
                  f"mesh path cboc: {counts}, want {n_blocks} of synth_kp_v5_cboc_f32 only")
            launches["synth_kp_v5_cboc_f32"] = counts["synth_kp_v5_cboc_f32"]
            single = [packed_to_iq16(synth_kp_cuda.synth_kp_packed(
                prepare_kp_inputs(batch, NSAMP, device=dev), N_K).cpu().numpy())
                for batch in fixture_engine(NAV, 3.0, E1_CBOC).batches(B)]
            same = all(np.array_equal(a, b) for a, b in zip(sharded, single))
            print(f"mesh path cboc ({n_blocks} blocks) identical to the packed CBOC kernel: {same}")
            check(same, "the sharded CBOC path differs from the packed CBOC kernel")

            acc = torch.ones((B, NSAMP, 2), dtype=torch.float32, device=dev)
            nccl_ms = median_ms(lambda: dist.all_reduce(acc, group=mesh.sat_group))
            print(f"time all_reduce NCCL 1 rank, ({B}, {NSAMP}, 2) float32: {nccl_ms:.4f} ms ({gpu})")

            dist_rates = []
            for rep in range(E2E_RUNS):
                args = cli.build_torch_parser().parse_args(
                    ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "10", "-t", FIXTURE_START,
                     "-l", llh, "-o", str(Path(tmp) / "e2e_dist.ishort")])
                engine, servers = cli.build_engine(args)
                timer = Timer()
                try:
                    t0 = time.perf_counter()
                    n = D.generate_file_distributed(engine, Path(tmp) / "e2e_dist.ishort",
                                                    mesh=mesh, timer=timer)
                    wall = time.perf_counter() - t0
                finally:
                    servers.stop()
                dist_rates.append(n * NSAMP / wall)
                print(f"e2e distributed 1 rank run {rep}: {n} epochs in {wall:.3f} s = "
                      f"{dist_rates[-1]:.0f} samples/s ({gpu})")
                print(timer.report())
            print(f"e2e distributed 1 rank median of {E2E_RUNS}: {np.median(dist_rates):.0f} "
                  f"samples/s ({gpu})")
        finally:
            dist.destroy_process_group()

        # two ranks sharing the card: gloo on CUDA tensors
        ranks_dir = Path(tmp) / "ranks"
        ranks_dir.mkdir()
        init = f"file://{ranks_dir / 'rendezvous'}"
        procs = [subprocess.Popen(
            [sys.executable, str(DIST_WORKER), "card", init, "2", str(rank), str(ranks_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
            for rank in range(2)]
        try:
            rank_outs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        cards = []
        for rank, (p, out) in enumerate(zip(procs, rank_outs)):
            check(p.returncode == 0 and f"RANK {rank} OK" in out,
                  f"two-rank worker {rank} failed (rc {p.returncode}):\n{out[-3000:]}")
            cards.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith("CARD "))[5:]))
        epochs3 = len(fixture_engine(NAV, 3.0))
        for card_ in cards:
            counts = dict(card_["counts"])
            check(counts.pop(PLANES) == counts["synth_kp_v5_f32"], f"two-rank prologue {counts}")
            print(f"two ranks, rank {card_['rank']} on {card_['device']}, mesh {card_['mesh']}: "
                  f"{card_['epochs']} epochs, launches={counts}")
            check(card_["mesh"] == {"sat": 2, "time": 1}, f"two-rank mesh {card_['mesh']}")
            check(card_["epochs"] == epochs3, f"two-rank run wrote {card_['epochs']} epochs")
            check(counts["synth_kp_v5_f32"] == -(-epochs3 // B) and sum(counts.values())
                  == counts["synth_kp_v5_f32"], f"two-rank launches {counts}")
        for fname in ("two_rank.ishort", "time2.ishort"):
            got = np.fromfile(ranks_dir / fname, dtype=np.int16)
            bar = psum_bar(got, default_iq)
            print(f"two ranks {fname} vs single-process: match={bar['match']:.6f} "
                  f"max_abs_err={bar['max_abs_err']}")
            check(bar["ok"], f"two ranks {fname}: {bar}")
        acquire_file(ranks_dir / "two_rank.ishort", "two ranks", E1_OS, MIN_METRIC)
        gloo_ms = float(np.median(cards[0]["allreduce_ms"]))
        print(f"time all_reduce gloo 2 ranks on one card, ({B}, {NSAMP}, 2) float32: median "
              f"{gloo_ms:.3f} ms of {cards[0]['allreduce_ms']} ({gpu})")
        for card_ in cards:
            print(f"e2e two ranks, rank {card_['rank']}: {card_['e2e_epochs']} epochs in "
                  f"{card_['e2e_wall_s']:.3f} s = {card_['e2e_samples_per_sec']:.0f} samples/s ({gpu})")
            print(card_["stages"])

        # --- 7. timings --------------------------------------------------
        times, timing_inputs = {}, {}
        for C in KP_CS:
            inputs = synthetic_kp_inputs(B, C, 100 + C, "random", dev)
            plain = median_ms(lambda: synth_kp_packed_ref(inputs, N_K))
            kern = median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            times[("synth_kp_v5", C)] = (kern, plain)
            print(f"time synth_kp_v5 B={B} n_k={N_K} C={C}: kernel {kern:.4f} ms, "
                  f"plain {plain:.4f} ms ({gpu})")
            if C == 8:
                timing_inputs["synth_kp_v5"] = (inputs, False)
        for name, variant in VARIANTS.items():
            if not variant:
                continue
            inputs = synthetic_kp_inputs(B, 8, 108, "random", dev, **variant)
            timing_inputs[name] = (inputs, False)
            plain = median_ms(lambda: synth_kp_packed_ref(inputs, N_K))
            kern = median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            times[(name, 8)] = (kern, plain)
            print(f"time {name} B={B} n_k={N_K} C=8: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                  f"({gpu})")
        # interactive (live) mode: one epoch a block
        for name, (variant, f32) in KP_INSTANTIATIONS.items():
            inputs = synthetic_kp_inputs(1, 8, 108, "random", dev, **variant)
            wrapper = synth_kp_cuda.synth_kp_accum if f32 else synth_kp_cuda.synth_kp_packed
            kern = median_ms(lambda: wrapper(inputs, N_K))
            print(f"time {name} B=1 n_k={N_K} C=8: kernel {kern:.4f} ms ({gpu})")
        # the pair of launches of a call, the prologue alone, the wrapper's
        # host time a call, and the launch floors (empty kernels of the
        # same grids and block sizes), at the file sink's block with 2, 8
        # and 16 channels and at live mode's one-epoch block
        planes_inputs = timing_inputs["synth_kp_v5"][0]
        planes_plain = median_ms(lambda: kp_planes_ref(planes_inputs, N_K))
        lib_kp, _ = synth_kp_cuda.library()
        floors = {}
        for Bp, C in ((B, 2), (B, 8), (B, 16), (1, 8)):
            inputs = (planes_inputs if (Bp, C) == (B, 8)
                      else synthetic_kp_inputs(Bp, C, 100 + C, "random", dev))
            geometry = synth_kp_cuda.launch_geometry(Bp, C, N_K)
            pair = median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            # the prologue's launch alone (`kp_planes` would add the copy
            # that decodes the chip words out of the scratch)
            pro = median_ms(lambda: synth_kp_cuda._launch_planes(lib_kp, inputs, N_K))
            host = host_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            floors[(Bp, C)] = (floor_ms(geometry[:1]), floor_ms(geometry))
            print(f"time pair B={Bp} n_k={N_K} C={C}: prologue and main kernel {pair:.4f} ms "
                  f"(floor {floors[(Bp, C)][1]:.4f}), {PLANES} alone {pro:.4f} ms (floor "
                  f"{floors[(Bp, C)][0]:.4f}; bound {planes_bound(inputs, N_K)[0]:.5f}), the "
                  f"wrapper's host time {host:.4f} ms a call; grids {geometry} ({gpu})")
            if (Bp, C) == (B, 8):
                planes_ms = pro
        planes_floor, pair_floor = floors[(B, 8)]
        print(f"time {PLANES} B={B} n_k={N_K} C=8: kernel {planes_ms:.4f} ms, plain "
              f"{planes_plain:.4f} ms ({gpu})")
        plain16 = median_ms(lambda: synth_kp_int16_ref(inputs16, N_K))
        kern16 = median_ms(lambda: synth_kp_cuda.synth_kp_int16(inputs16, N_K))
        print(f"time int16 view (cboc_gain) B={B} n_k={N_K} C=8: kernel {kern16:.4f} ms, "
              f"plain {plain16:.4f} ms ({gpu})")
        for name, cboc in F32.items():
            inputs = synthetic_kp_inputs(B, 8, 108, "random", dev, cboc=cboc)
            timing_inputs[name] = (inputs, True)
            plain = median_ms(lambda: synth_kp_accum_ref(inputs, N_K))
            kern = median_ms(lambda: synth_kp_cuda.synth_kp_accum(inputs, N_K))
            packed = median_ms(lambda: synth_kp_cuda.synth_kp_packed(inputs, N_K))
            times[(name, 8)] = (kern, plain)
            print(f"time {name} B={B} n_k={N_K} C=8: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
                  f"packed store {packed:.4f} ms ({gpu})")
        # what one call costs the host (ctypes, operand checks, the output
        # allocation), beside the device times above
        for name, (inputs, f32) in timing_inputs.items():
            wrapper = synth_kp_cuda.synth_kp_accum if f32 else synth_kp_cuda.synth_kp_packed
            print(f"time {name}: the wrapper's host time {host_ms(lambda: wrapper(inputs, N_K)):.4f} "
                  f"ms a call ({gpu})")
        # the gather kernel on the probe's seven shapes, beside its plain
        # version (int32 indices, widened) and torch.take_along_dim (int64
        # indices made beforehand), timed as a yardstick only
        gather = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0}
        gen = torch.Generator().manual_seed(0)
        for shape, maxidx, axis in gather_probe.PROBES:
            tab, idx = (t.to(dev) for t in gather_probe.probe_inputs(shape, maxidx, gen))
            idx64 = idx.long()
            t_g = {
                "ms": median_ms(lambda: gather_probe.take_along_axis(tab, idx, axis)),
                "plain_ms": median_ms(lambda: gather_probe.take_along_axis_ref(tab, idx, axis)),
                "library_ms": median_ms(lambda: torch.take_along_dim(tab, idx64, dim=axis)),
                "bound_ms": bound(0, gather_bytes(idx, axis))[0],
                "floor_ms": floor_ms([gather_probe.launch_geometry(*shape, axis)]),
            }
            for key, val in t_g.items():
                gather[key] += val
            print(f"time gather {shape} axis={axis}: kernel {t_g['ms']:.5f} ms, plain "
                  f"{t_g['plain_ms']:.5f} ms, torch.take_along_dim {t_g['library_ms']:.5f} ms, "
                  f"bound {t_g['bound_ms']:.6f} ms, floor {t_g['floor_ms']:.5f} ms ({gpu})")
        rng = np.random.default_rng(0)
        stack = torch.from_numpy(
            rng.integers(-2500, 2500, (bandlimit.OS, B, 2 * 260000)).astype(np.int16)).to(dev)
        hist = bandlimit.initial_state(dev)
        filt = median_ms(lambda: bandlimit.filter_block(stack, hist, B), n=10, per=5)
        print(f"time band-limit filter per B={B} block: {filt:.4f} ms ({gpu})")
        del stack

        def e2e(options: list, duration: float, label: str) -> None:
            rates = []
            for rep in range(E2E_RUNS):
                e2e_out = Path(tmp) / f"e2e{rep}.ishort"
                args = cli.build_torch_parser().parse_args(
                    ["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(duration),
                     "-t", FIXTURE_START, "-l", llh, "-o", str(e2e_out), *options]
                )
                run = cli.build_run(args)
                before = synth_kp_cuda.launch_count
                try:
                    t0 = time.perf_counter()
                    stats = run.synth.run()
                    wall = time.perf_counter() - t0
                finally:
                    run.close()
                n_launch = synth_kp_cuda.launch_count - before
                check(e2e_out.stat().st_size == stats.samples * 4, "e2e file size")
                e2e_out.unlink()
                rates.append(stats.samples / wall)
                print(f"e2e {label} run {rep}: {stats.epochs} epochs, {stats.samples} samples "
                      f"in {wall:.3f} s = {rates[-1]:.0f} samples/s, {n_launch} kernel "
                      f"launches ({gpu})")
                print(stats.stage_report())
            print(f"e2e {label} median of {E2E_RUNS}: {np.median(rates):.0f} samples/s ({gpu})")

        e2e([], 30, "file sink")
        e2e(["--bandlimit"], 10, "bandlimit")

        # device time of a --bandlimit run, by kernel, under the profiler
        from torch.profiler import ProfilerActivity, profile

        args = cli.build_torch_parser().parse_args(
            ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "5", "-t", FIXTURE_START,
             "-l", llh, "-o", str(Path(tmp) / "prof.ishort"), "--bandlimit"]
        )
        run = cli.build_run(args)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run.synth.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            run.close()
        # device-side events only (kernels, copies, memsets): a host op's
        # row repeats the device time of the kernels it launched
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
        busy_us = sum(r[1] for r in rows)
        print(f"profile bandlimit 5 s: device time {busy_us / 1e3:.3f} ms in {wall * 1e3:.1f} ms "
              f"wall = {busy_us / 1e6 / wall:.2%} busy ({gpu})")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
            print(f"  {us / 1e3:9.3f} ms  {count:5d} x  {key[:100]}")

        # the jump scene's CPU run (phase 9) goes beside phase 8's receiver
        # runs, as a process of its own: the CLI with --device cpu
        jump_motion = write_jump_motion(Path(tmp) / "jump.csv")
        jump_argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(JUMP_SECONDS),
                     "-t", FIXTURE_START, "-l", llh, "-u", jump_motion]
        jump_cpu = Path(tmp) / "jump_cpu.ishort"
        t_jump_cpu = time.perf_counter()
        cpu_run = subprocess.Popen(
            [sys.executable, "-m", "galileo_sdr_sim_tpu_torch", *jump_argv, "-o", str(jump_cpu),
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
            env={**os.environ, "OMP_NUM_THREADS": "4"})

        # --- 8. the acceptance tier and the stream modes ------------------
        def drive(argv: list, label: str) -> dict:
            """cli.main once, the counts set to 0 just before and read just
            after -> {instantiation: launches} (prologue and int16 views
            under their own keys)."""
            synth_kp_cuda.reset_counts()
            rc = cli.main(argv)
            counts = dict(synth_kp_cuda.launch_counts)
            counts["int16"] = synth_kp_cuda.int16_launch_count
            print(f"main path {label}: rc={rc} launches={counts}")
            check(rc == 0, f"cli.main {label} returned {rc}")
            return counts

        def tally(counts: dict) -> None:
            nonlocal launches_int16
            for name, n in counts.items():
                if name == "int16":
                    launches_int16 += n
                else:
                    launches[name] += n

        def only(counts: dict, name: str, want: int, label: str) -> None:
            ran = {k: v for k, v in counts.items() if v and k not in (PLANES, "int16")}
            check(ran == {name: want} and counts[PLANES] == want,
                  f"{label}: launches {counts}, want {want} of {name} and its prologue")

        pvt_epochs = len(ScenarioEngine(nav_fx, PositionProvider(llh_deg=np.array(FIXTURE_LLH)),
                                        pvt_g0, PVT_SECONDS))
        pvt_blocks = -(-pvt_epochs // B)
        pvt_argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-t", PVT_START, "-l", llh,
                    "-d", str(PVT_SECONDS)]
        pvt_bars = {"default": 15.0, "bandlimit": 20.0}  # metres: the JAX package's bars
        for label, options, name, per_block in (
                ("default", [], "synth_kp_v5", 1),
                ("bandlimit", ["--bandlimit"], "synth_kp_v5_cboc", bandlimit.OS)):
            out = Path(tmp) / f"pvt_{label}.ishort"
            counts = drive([*pvt_argv, "-o", str(out), *options], f"PVT {label}")
            only(counts, name, pvt_blocks * per_block, f"PVT {label}")
            check(label != "bandlimit" or counts["int16"] == pvt_blocks * per_block,
                  "the band-limited PVT run did not go through the int16 view")
            tally(counts)
            check(out.stat().st_size == pvt_epochs * NSAMP * 4, f"PVT {label}: file size")
            fix = pvt_fix(out, NAV)
            print(f"PVT {label} ({pvt_epochs} epochs from {PVT_START}): {fix['n_sats']} satellites "
                  f"{fix['fix_prns']} of {fix['prns']}, error {fix['err_m']:.3f} m, max residual "
                  f"{fix['max_residual_m']:.3f} m, t_rx error {fix['t_rx_err_s']:.3g} s, receiver "
                  f"{fix['seconds']:.1f} s")
            check(fix["n_sats"] >= 5 and fix["err_m"] < pvt_bars[label],
                  f"PVT {label}: no fix within {pvt_bars[label]} m from >= 5 satellites: {fix}")
            check(label != "default" or fix["t_rx_err_s"] < 1e-5, f"PVT {label}: receive time {fix}")

        # the pipelined default run: the depth-1 file's bytes, its launches
        out = Path(tmp) / "pvt_depth3.ishort"
        counts = drive([*pvt_argv, "-o", str(out), "--pipeline-depth", "3"], "PVT --pipeline-depth 3")
        only(counts, "synth_kp_v5", pvt_blocks, "--pipeline-depth 3")
        tally(counts)
        same = out.read_bytes() == (Path(tmp) / "pvt_default.ishort").read_bytes()
        print(f"--pipeline-depth 3 file byte-identical to the depth-1 file: {same}")
        check(same, "the --pipeline-depth 3 file differs from the depth-1 file")

        # checkpoint crash and resume: depth 3, a snapshot every block of 2
        # epochs, a sink that stops the run after 3 blocks; a fresh
        # executor resumes; drained + resumed = one depth-1 run
        class Collect(Sink):
            def __init__(self, stop_after: int = 0):
                self.blocks, self.stop_after, self.synth = [], stop_after, None

            def write(self, iq) -> None:
                self.blocks.append(np.array(iq, copy=True))
                if self.stop_after and len(self.blocks) >= self.stop_after:
                    self.synth.stop()

        def stream_bytes(sink) -> bytes:
            return b"".join(b.tobytes() for b in sink.blocks)

        ck = str(Path(tmp) / "resume.ckpt")
        synth_kp_cuda.reset_counts()
        whole = Collect()
        StreamingSynthesizer(fixture_engine(NAV, 2.0), whole, device=dev, block_epochs=2).run()
        crashed = Collect(stop_after=3)
        crashed.synth = StreamingSynthesizer(fixture_engine(NAV, 2.0), crashed, device=dev,
                                             block_epochs=2, pipeline_depth=3, checkpoint_path=ck,
                                             checkpoint_every=2)
        crashed.synth.run()
        resumed = Collect()
        again = StreamingSynthesizer(fixture_engine(NAV, 2.0), resumed, device=dev, block_epochs=2,
                                     pipeline_depth=3, checkpoint_path=ck)
        start = again._start_epoch
        again.run()
        counts = dict(synth_kp_cuda.launch_counts)
        tally(counts)
        drained = sum(b.shape[0] for b in crashed.blocks)
        same = stream_bytes(crashed) + stream_bytes(resumed) == stream_bytes(whole)
        print(f"checkpoint: crashed after {len(crashed.blocks)} blocks ({drained} epochs), resumed "
              f"at epoch {start}, launches={counts}; drained + resumed byte-identical to one "
              f"depth-1 run: {same}")
        check(drained == 6 and start == drained + 1, "the snapshot does not hold the sink's position")
        check(same, "crash and resume differs from the uninterrupted run")

        # the device-resident drain: on-card sums equal the host drain's
        for depth in (1, 3):
            synth_kp_cuda.reset_counts()
            on_card = AbsSumSink()
            StreamingSynthesizer(fixture_engine(NAV, 3.0), on_card, device=dev, drain_host=False,
                                 pipeline_depth=depth).run()
            counts = dict(synth_kp_cuda.launch_counts)
            only(counts, "synth_kp_v5", len(on_card.sums), "device-resident drain")
            tally(counts)
            on_host = AbsSumSink()
            StreamingSynthesizer(fixture_engine(NAV, 3.0), on_host, device=dev,
                                 pipeline_depth=depth).run()
            print(f"device-resident drain depth {depth}: {len(on_card.sums)} blocks on "
                  f"{sorted(set(on_card.kinds))}, sums equal the host drain's: "
                  f"{on_card.sums == on_host.sums}, launches={counts}")
            check(set(on_card.kinds) == {"cuda"}, f"device-resident sink got {on_card.kinds}")
            check(on_card.sums == on_host.sums and len(on_card.sums) > 0,
                  "device-resident sums differ from the host drain's")

        # live mode at B = 1, depth 1: an update sent while block 1 drains
        # reaches block 3's samples
        synth_kp_cuda.reset_counts()
        live = live_pickup(NAV, dev, free_udp_ports(3))
        counts = dict(synth_kp_cuda.launch_counts)
        tally(counts)
        print(f"live B=1 on the card: {live}, launches={counts}")
        check(live["ok"], f"live mode at B = 1: {live}")
        check(counts["synth_kp_v5"] == live["blocks"] - live["fallback_blocks"],
              f"live mode launches {counts}")

        # file-sink rate, depth 1 and depth 3 in turns (written down only)
        rates = {1: [], 3: []}
        for depth in (1, 3, 3, 1, 1, 3):
            e2e_out = Path(tmp) / "e2e_depth.ishort"
            args = cli.build_torch_parser().parse_args(
                ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "30", "-t", FIXTURE_START, "-l", llh,
                 "-o", str(e2e_out), "--pipeline-depth", str(depth)])
            run = cli.build_run(args)
            try:
                t0 = time.perf_counter()
                stats = run.synth.run()
                wall = time.perf_counter() - t0
            finally:
                run.close()
            check(e2e_out.stat().st_size == stats.samples * 4, "e2e file size")
            e2e_out.unlink()
            rates[depth].append(stats.samples / wall)
            print(f"e2e depth {depth}: {stats.epochs} epochs in {wall:.3f} s = {rates[depth][-1]:.0f} "
                  f"samples/s ({gpu})")
            print(stats.stage_report())
        for depth, r in rates.items():
            print(f"e2e file sink depth {depth}, 30 s: median {np.median(r):.0f} min {min(r):.0f} "
                  f"max {max(r):.0f} samples/s of {len(r)} runs ({gpu})")

        # --- 9. the direct fallback through the CLI ------------------------
        try:
            cpu_out = cpu_run.communicate(timeout=JUMP_CPU_TIMEOUT_S)[0]
        finally:
            cpu_run.kill()
            cpu_run.wait()
        print(f"jump scene --device cpu: rc={cpu_run.returncode}, done within "
              f"{time.perf_counter() - t_jump_cpu:.1f} s of its start")
        check(cpu_run.returncode == 0, f"the CLI with --device cpu failed:\n{cpu_out[-3000:]}")
        blocks = jump_scene_blocks(NAV, jump_motion)
        n_fallback = sum(b["fallback"] for b in blocks)
        print(f"jump scene: {sum(b['epochs'] for b in blocks)} epochs in {len(blocks)} blocks, "
              f"{n_fallback} outside the envelope (first epochs "
              f"{[b['first'] for b in blocks if b['fallback']]}), "
              f"{len({tuple(b['prn']) for b in blocks})} channel maps")
        check(n_fallback >= 1, "the jump scene has no block outside the envelope")
        jump_card = Path(tmp) / "jump_card.ishort"
        counts = drive([*jump_argv, "-o", str(jump_card)], "jump scene (no --device)")
        only(counts, "synth_kp_v5", len(blocks) - n_fallback, "jump scene")
        tally(counts)
        cmp_ = compare_jump_files(jump_card, jump_cpu, blocks)
        print(f"jump scene card vs --device cpu: every epoch present={cmp_['complete']}, "
              f"{cmp_['kp_blocks']} kp blocks {cmp_.get('kp')}, {cmp_['fallback_blocks']} fallback "
              f"blocks {cmp_.get('fallback')}")
        check(cmp_["complete"], "a jump-scene file does not hold every epoch")
        check(cmp_["kp"]["ok"] and cmp_["fallback"]["ok"], f"jump scene, card against CPU: {cmp_}")
        check(cmp_["fallback_blocks"] == n_fallback >= 1, "fallback blocks")
        last = blocks[-2] if blocks[-1]["epochs"] < B else blocks[-1]
        check(not last["fallback"] and tuple(last["prn"]) != tuple(blocks[0]["prn"]),
              "the last full block is not a kp block of the reallocated channels")
        for a in acquire_block(jump_card, last):
            print(f"acquire jump scene, epoch {last['first']}, PRN {a['prn']:2d}: metric "
                  f"{a['metric']:6.1f} doppler {a['doppler']:7.0f} (engine {a['f_carr']:8.1f})")
            check(a["metric"] >= MIN_METRIC, f"jump scene: PRN {a['prn']} not acquired")
            check(abs(a["doppler"] - a["f_carr"]) <= 100.0, f"jump scene: PRN {a['prn']} Doppler")
        # the direct engine's device time for one fallback block: its
        # epochs' operands prepared on the card first, then the
        # `synth_block` calls of the block between two CUDA events
        from galileo_sdr_sim_tpu_torch.io.stream import _slice_epoch
        from galileo_sdr_sim_tpu_torch.ops.synth import TILE, prepare_device_inputs, synth_block

        engine, _ = cli.build_engine(cli.build_torch_parser().parse_args(jump_argv))
        batch = next(b for b in engine.batches(B) if not mu_in_envelope(b.f_code))
        n_real = batch.f_code.shape[0]
        epochs_in = [prepare_device_inputs(_slice_epoch(batch, e), TILE, NSAMP, pad_epochs=1,
                                           device=dev) for e in range(n_real)]
        direct_ms = median_ms(lambda: [synth_block(x, tile=TILE, mode="float") for x in epochs_in],
                              n=10, per=1)
        print(f"time direct engine, one fallback block of {n_real} epochs x "
              f"{batch.prn.size} channels: {direct_ms:.4f} ms on the card, "
              f"{direct_ms / n_real:.4f} ms an epoch ({gpu})")

    kp_source = "galileo_sdr_sim_tpu_torch/csrc/synth_kp_v5.cu"

    def entry(name, source, replaces, n_launch, err, ms, plain_ms, bound_, floor, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_[0], "bound_by": bound_[1], "floor_ms": floor,
                "library_ms": library_ms}

    entries = []
    for name in (*VARIANTS, *F32):
        inputs, f32 = timing_inputs[name]
        entries.append(entry(name, kp_source, synth_kp_cuda.REPLACES[name], launches[name],
                             worst[name], *times[(name, 8)], kp_bound(inputs, N_K, f32),
                             pair_floor))
    entries.append(entry("synth_kp_v5_int16", kp_source, synth_kp_cuda.INT16_REPLACES,
                         launches_int16, worst_int16, kern16, plain16, kp_bound(inputs16, N_K),
                         pair_floor))
    entries.append(entry(PLANES, kp_source, synth_kp_cuda.REPLACES[PLANES], launches[PLANES],
                         worst_planes, planes_ms, planes_plain, planes_bound(planes_inputs, N_K),
                         planes_floor))
    entries.append(entry("gather_probe", "galileo_sdr_sim_tpu_torch/csrc/gather_probe.cu",
                         gather_probe.REPLACES, launches["gather_probe"], 0, gather["ms"],
                         gather["plain_ms"], (gather["bound_ms"], "bytes"), gather["floor_ms"],
                         gather["library_ms"]))
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched by its main path")
    print(json.dumps({"kernels": entries}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
