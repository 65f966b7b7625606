"""Seeded synthetic operands for parity checks that need no RINEX file.

`synthetic_operands` makes, with numpy from a seed, the seeded float32
host operands of the factorized engine (the dict that
`prepare_kp_inputs` builds from an EpochBatch) plus real E1 code banks,
so the same inputs can go through the JAX engines, the plain PyTorch
version and the CUDA kernel.  The adversarial cases are those the JAX
package checks its Pallas kernel with (bench.py parity cases,
tests/test_synth_kp_pallas.py edge seeds).

`fixture_engine` is the real scene of the repository's fixture nav file
(tests/data/obs_fixture_nav.rnx): 2022-02-19 23:30:00 at Boston, 7
satellites in view, every epoch inside the factorized engine's envelope.

`engine_bar` is the parity bar the port is held to on the int16 values
of the packed output; `cboc_bar` its CBOC counterpart, and
`bandlimit_bar` the per-sample bound of the band-limited stream.

`kp_digests` takes the SHA-256 of each kp kernel instantiation's output
on fixed cases (`kp_digest_cases`): the same-bits guard that a rewrite
of the kernel is held to (tests/data/torch_kp_digests.json).

The acceptance checks of a port-made stream: `pvt_fix` runs the in-repo
receiver (acquisition, tracking, I/NAV decode, least-squares PVT) on a
file of the fixture site's scene from PVT_START; `live_pickup` drives
interactive mode at B = 1 and measures when a UDP position update
reaches the samples; `AbsSumSink` is a device-resident consumer for
`drain_host=False`.  The jump scene (`write_jump_motion`,
`jump_scene_blocks`, `compare_jump_files`, `acquire_block`) sends one
block of a file-sink run through the direct fallback and holds two files
of the scene to each other route by route.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import time
from pathlib import Path

import numpy as np
import torch

from .cli import _parse_time
from .constants import CA_SEQ_LEN_E1, EPOCH_DT, LUT_AMPLITUDE, NUM_IQ_SAMPLES, R2D, SAMP_RATE
from .geodesy import llh2xyz
from .io.sinks import Sink
from .models.cboc import E1_CBOC
from .models.e1 import E1_OS
from .ops.bandlimit import polyphase_kernel
from .ops.synth_kp import (
    COLS, GAIN_OPERAND, K_EPOCH, P_GRID, _pack_codes_rs, cboc_sign_banks, cboc_weights,
    kernel_operands, operands_to_device, prepare_kp_inputs,
)
from .rinex import read_rinex_v3
from .scenario import PositionProvider, ScenarioEngine, scenario_start_time

CASES = ("random", "half_chip", "carrier_wrap", "negated_mu", "edges")
BAR_MATCH = 0.999  # share of int16 values that must be identical
BAR_MAX_DIFF = 4 * LUT_AMPLITUDE  # one chip-transition timing ULP (1000)
# CBOC has 12 transitions a chip against sine-BOC's 2, so 6x the share
# of samples that sit one float32 ULP from an edge.  The reference's own
# ceiling between its two CBOC engines is 99.4% (tests/
# test_synth_kp_pallas.py: mismatch < 6e-3); the port measures >= 99.90%
# against either JAX engine and >= 99.97% kernel against plain version,
# so the bar is tightened to 99.8%
CBOC_BAR_MATCH = 0.998
BL_SLACK = 2  # band-limit filter: trunc of float32 sums straddling an integer

# kp kernel instantiation -> (the `synthetic_operands` variant that
# selects it, whether it is the f32 emit)
KP_INSTANTIATIONS = {
    "synth_kp_v5": ({}, False),
    "synth_kp_v5_gain": (dict(gain=True), False),
    "synth_kp_v5_cboc": (dict(cboc=True), False),
    "synth_kp_v5_cboc_gain": (dict(cboc=True, gain=True), False),
    "synth_kp_v5_f32": ({}, True),
    "synth_kp_v5_cboc_f32": (dict(cboc=True), True),
}
DIGEST_CS = (2, 8, 16)  # channel counts of the digest cases
DIGEST_B = 8  # epochs a block of the digest cases

FIXTURE_START = "2022/02/19,23:30:00"  # GST week 2197, 603000 s
FIXTURE_LLH = (42.3601, -71.0589, 2.0)  # Boston, the CLI's default site
# the PVT scene starts at tow 603018, 18 mod 30: the I/NAV schedule then
# puts every ephemeris word type on the air within PVT_SECONDS (as the
# JAX package's PVT scene at tow 28818 does), and start + 19 s stays
# inside the fixture nav file's GST 597600-603600 s
PVT_START = "2022/02/19,23:30:18"
PVT_SECONDS = 19.0
LIVE_MOVE = (43.0, -70.0, 50.0)  # ~110 km from the fixture site
# the jump scene: a user-motion file of 10 Hz rows, 15 s at the fixture
# site, then 1370 km south of it.  The block that holds the jump leaves
# the factorized engine's code-Doppler envelope and goes through the
# direct engine; at the 30 s boundary the channels are reallocated
JUMP_LLH = (30.0, -71.0589, 2.0)
JUMP_ROWS = (150, 170)
JUMP_SECONDS = 32.0


def fixture_engine(nav_path, duration_s: float, model=E1_OS) -> ScenarioEngine:
    """The fixture scene of the nav file at `nav_path`, static receiver,
    with the signal `model` (E1_OS sine-BOC, or E1_CBOC)."""
    nav = read_rinex_v3(nav_path)
    g0 = scenario_start_time(nav, _parse_time(FIXTURE_START))
    return ScenarioEngine(
        nav, PositionProvider(llh_deg=np.array(FIXTURE_LLH)), g0, duration_s, model=model
    )


def synthetic_operands(
    B: int, C: int, seed: int, case: str = "random", *, cboc: bool = False, gain: bool = False
) -> tuple:
    """-> (host, codes_b, codes_c): host holds (B, C) float32 cp0, two_a,
    mu, carr0, fc, fc_k and (B, C, 32) float32 +-1 sym_win, pilot_win;
    codes are the (C, 8184) int8 E1B/E1C banks of PRNs 1..C.

    `cboc`: the banks are the signs of E1_CBOC's 12-grid tables and host
    gains `cboc_ab`, both derived as ops/synth_kp.prepare_kp_inputs
    derives them.  `gain`: host gains a seeded (B, C) float32
    `chan_gain` in (0, 1].  Either leaves the other draws unchanged.

    Cases: 'random'; 'half_chip' (code phases exactly on half chips);
    'carrier_wrap' (carrier phase just under 1 cycle); 'negated_mu'
    (negative code-Doppler drift); 'edges' (cp0 at 0 and just under
    4092, mu at +-3e-3 and 0).  Every case draws |fc| up to 3e-3
    cycles/sample, so fc_k wraps within the epoch."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    if not 1 <= C <= len(E1_OS.data_codes):
        raise ValueError(f"C={C} channels: need 1..{len(E1_OS.data_codes)}")
    rng = np.random.default_rng(seed)
    cp0 = rng.uniform(0, 4 * COLS, (B, C))
    mu = rng.uniform(-3e-3, 3e-3, (B, C))
    carr0 = rng.uniform(0, 1, (B, C))
    if case == "half_chip":
        cp0 = np.round(cp0 * 2) / 2
    elif case == "carrier_wrap":
        carr0 = np.full((B, C), np.nextafter(np.float32(1), np.float32(0)))
    elif case == "negated_mu":
        mu = -rng.uniform(5e-4, 3e-3, (B, C))
    elif case == "edges":
        cp0.flat[0] = 0.0
        cp0.flat[1 % cp0.size] = 4091.9999
        cp0.flat[C % cp0.size] = 2046.0
        mu[0, :] = 3e-3
        mu[min(1, B - 1), :] = -3e-3
        mu[-1, 0] = 0.0
    mu = mu.astype(np.float32)
    fc = rng.uniform(-3e-3, 3e-3, (B, C))
    fc_k = fc * P_GRID
    host = dict(
        cp0=cp0.astype(np.float32),
        two_a=((mu.astype(np.float64) + COLS) / P_GRID).astype(np.float32),
        mu=mu,
        carr0=carr0.astype(np.float32),
        fc=fc.astype(np.float32),
        fc_k=(fc_k - np.floor(fc_k)).astype(np.float32),
        sym_win=rng.choice([-1.0, 1.0], (B, C, 32)).astype(np.float32),
        pilot_win=rng.choice([-1.0, 1.0], (B, C, 32)).astype(np.float32),
    )
    if cboc:
        tab_b = E1_CBOC.data_codes[:C]
        tab_c = E1_CBOC.pilot_codes[:C]
        host["cboc_ab"] = cboc_weights(tab_b)
        codes_b, codes_c = cboc_sign_banks(tab_b, tab_c, host["cboc_ab"])
    else:
        codes_b = np.ascontiguousarray(E1_OS.data_codes[:C])
        codes_c = np.ascontiguousarray(E1_OS.pilot_codes[:C])
    if gain:
        host[GAIN_OPERAND] = (1.0 - rng.uniform(0, 1, (B, C))).astype(np.float32)
    return host, codes_b, codes_c


def synthetic_kp_inputs(
    B: int, C: int, seed: int, case: str, device, *, cboc: bool = False, gain: bool = False
) -> dict:
    """`synthetic_operands` as the kernel's operands on `device` (what
    `prepare_kp_inputs` returns for a scene)."""
    host, codes_b, codes_c = synthetic_operands(B, C, seed, case, cboc=cboc, gain=gain)
    inputs = operands_to_device(kernel_operands(host), device)
    inputs["vpack_rs"] = torch.from_numpy(_pack_codes_rs(codes_b, codes_c)).to(device)
    return inputs


def _int16(x) -> np.ndarray:
    """Packed int32 or int16 I/Q (numpy or tensor) -> int32 numpy of the
    int16 values, in stream order."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(x).view(np.int16).astype(np.int32)


def engine_bar(a_packed, b_packed, match_bar: float = BAR_MATCH) -> dict:
    """Compare two packed int32 (or int16) I/Q outputs on their int16
    values -> {'match': share identical, 'max_abs_err': largest
    |difference|, 'ok': whether the bar holds}."""
    a, b = _int16(a_packed), _int16(b_packed)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    match = float((diff == 0).mean()) if diff.size else 1.0
    max_err = int(diff.max()) if diff.size else 0
    return {
        "match": match,
        "max_abs_err": max_err,
        "ok": match >= match_bar and max_err <= BAR_MAX_DIFF,
    }


def cboc_bar(a_packed, b_packed) -> dict:
    """`engine_bar` at the CBOC share: >= 99.8% of int16 values
    identical, every difference within 1000."""
    return engine_bar(a_packed, b_packed, CBOC_BAR_MATCH)


def bandlimit_bar(y_a, y_b, x_a, x_b) -> dict:
    """Per-sample bound of two band-limited streams, y (n, 2) or flat
    interleaved int16, made by the same filter from two phase stacks x
    (12, n, 2), all in stream order from the same zero history:

        |y_a - y_b| <= (|K| * |x_a - x_b|) + 2

    with K the polyphase kernel (ops/bandlimit.py): each output sample
    may move by what the input differences can move it through the
    filter, plus the trunc slack.  -> {'match', 'max_abs_err',
    'max_excess' (largest |dy| - bound), 'ok'}."""
    ya, yb = _int16(y_a).reshape(-1, 2), _int16(y_b).reshape(-1, 2)
    xa = _int16(x_a).reshape(x_a.shape[0], -1, 2)
    xb = _int16(x_b).reshape(x_b.shape[0], -1, 2)
    n = ya.shape[0]
    if yb.shape != ya.shape or xa.shape != xb.shape or xa.shape[1] != n:
        raise ValueError(f"shapes differ: y {ya.shape} {yb.shape}, x {xa.shape} {xb.shape}")
    kern = np.abs(polyphase_kernel()[0].astype(np.float64))  # (12, 33)
    dx = np.abs(xa - xb).astype(np.float64)
    bound = np.full((n, 2), float(BL_SLACK))
    # out[i] = sum_j sum_t K[j, t] x_j[i + t - 32]: causal in x
    for j in range(kern.shape[0]):
        g = kern[j, ::-1]
        for q in range(2):
            if dx[j, :, q].any():
                bound[:, q] += np.convolve(dx[j, :, q], g)[:n]
    dy = np.abs(ya - yb)
    excess = float((dy - bound).max()) if dy.size else 0.0
    return {
        "match": float((dy == 0).mean()) if dy.size else 1.0,
        "max_abs_err": int(dy.max()) if dy.size else 0,
        "max_excess": excess,
        "ok": excess <= 1e-9,
    }


def kp_digest_cases(name: str, nav_path, device):
    """Yield (key, operands on `device`) of the digest cases of kp
    instantiation `name`: B = 8 epochs, the five CASES at C = 2, 8 and
    16 (seed 100 + C), then the first block of the fixture scene of the
    nav file at `nav_path` (its CBOC model for CBOC, with gain for gain),
    compacted to C = 8."""
    variant, _ = KP_INSTANTIATIONS[name]
    for C in DIGEST_CS:
        for case in CASES:
            yield f"C={C} {case}", synthetic_kp_inputs(DIGEST_B, C, 100 + C, case, device, **variant)
    model = E1_CBOC if variant.get("cboc") else E1_OS
    batch = next(fixture_engine(nav_path, 1.0, model).batches(DIGEST_B))
    yield "fixture", prepare_kp_inputs(batch, K_EPOCH * P_GRID, pad_epochs=DIGEST_B,
                                       device=device, apply_gain=bool(variant.get("gain")))


def kp_digest(out: torch.Tensor) -> str:
    """SHA-256 of a kernel output's bytes (packed int32 or float32)."""
    return hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()


def kp_digests(cuda_module, name: str, nav_path, device) -> dict:
    """{case key: digest} of instantiation `name` on its digest cases,
    full 0.1 s epochs (n_k = 200), through the wrappers of
    `cuda_module` (ops/synth_kp_cuda, or its counterpart in another
    checkout)."""
    _, f32 = KP_INSTANTIATIONS[name]
    fn = cuda_module.synth_kp_accum if f32 else cuda_module.synth_kp_packed
    return {key: kp_digest(fn(inputs, K_EPOCH))
            for key, inputs in kp_digest_cases(name, nav_path, device)}


class AbsSumSink(Sink):
    """A device-resident consumer: reduces each block to the int64 sum of
    |x| over its int16 values on the device the block lies on (packed
    int32 blocks viewed as their int16 pairs), and records where each
    block lay ('cuda', 'cpu', or 'numpy' for a host array)."""

    def __init__(self):
        self.sums: list[int] = []
        self.kinds: list[str] = []

    def write(self, block) -> None:
        if isinstance(block, torch.Tensor):
            self.kinds.append(block.device.type)
        else:
            self.kinds.append("numpy")
            block = torch.from_numpy(np.ascontiguousarray(block))
        if block.dtype == torch.int32:
            block = block.view(torch.int16)
        self.sums.append(int(block.to(torch.int64).abs().sum()))


def write_jump_motion(path, rows: tuple = JUMP_ROWS) -> str:
    """Write the jump scene's user-motion file (lat,lon,hgt rows at 10 Hz):
    rows[0] rows at FIXTURE_LLH, then rows[1] at JUMP_LLH."""
    lines = [FIXTURE_LLH] * rows[0] + [JUMP_LLH] * rows[1]
    with open(path, "w") as fh:
        fh.write("".join(",".join(str(v) for v in row) + "\n" for row in lines))
    return str(path)


def jump_scene_blocks(nav_path, motion_path, duration_s: float = JUMP_SECONDS,
                      block_epochs: int = 8) -> list:
    """Walk the scene of a user-motion file from FIXTURE_START as the CLI
    builds it -> one dict a block of `block_epochs` epochs: 'first' (the
    index of its first epoch in the stream), 'epochs', 'fallback' (an
    epoch outside the factorized engine's envelope: the streaming
    executor sends the block through the direct engine), 'prn' (the
    channel map) and 'f_carr' (each channel's carrier Doppler at the
    block's first epoch)."""
    from .cli import load_user_motion
    from .ops.synth_kp import mu_in_envelope

    nav = read_rinex_v3(nav_path)
    g0 = scenario_start_time(nav, _parse_time(FIXTURE_START))
    position = PositionProvider(trajectory=load_user_motion(str(motion_path)))
    blocks, first = [], 0
    for batch in ScenarioEngine(nav, position, g0, duration_s).batches(block_epochs):
        n = batch.f_code.shape[0]
        blocks.append({"first": first, "epochs": n, "fallback": not mu_in_envelope(batch.f_code),
                       "prn": batch.prn.copy(), "f_carr": batch.f_carr[0].copy()})
        first += n
    return blocks


def compare_jump_files(got_path, ref_path, blocks: list, nsamples: int = NUM_IQ_SAMPLES) -> dict:
    """Two int16 I/Q files of one scene, block by block (`jump_scene_blocks`)
    -> {'epochs' (the scene's), 'complete' (both files hold every epoch),
    'kp' and 'fallback' (`engine_bar` over the blocks of each route:
    'match', 'max_abs_err', 'ok'; both routes are float-carrier engines),
    'kp_blocks', 'fallback_blocks'}."""
    epochs = sum(b["epochs"] for b in blocks)
    size = epochs * nsamples * 4
    out = {"epochs": epochs, "kp_blocks": 0, "fallback_blocks": 0,
           "complete": all(Path(p).stat().st_size == size for p in (got_path, ref_path))}
    if not out["complete"]:
        return out
    got = np.memmap(got_path, dtype=np.int16, mode="r")
    ref = np.memmap(ref_path, dtype=np.int16, mode="r")
    same = {"kp": 0, "fallback": 0}
    total = dict(same)
    worst = dict(same)
    for b in blocks:
        route = "fallback" if b["fallback"] else "kp"
        out[f"{route}_blocks"] += 1
        lo, hi = (2 * nsamples * e for e in (b["first"], b["first"] + b["epochs"]))
        diff = np.abs(got[lo:hi].astype(np.int32) - ref[lo:hi])
        same[route] += int((diff == 0).sum())
        total[route] += diff.size
        worst[route] = max(worst[route], int(diff.max()))
    for route in same:
        match = same[route] / total[route] if total[route] else 1.0
        out[route] = {"match": match, "max_abs_err": worst[route],
                      "ok": match >= BAR_MATCH and worst[route] <= BAR_MAX_DIFF}
    return out


def acquire_block(iq_path, block: dict, nsamples: int = NUM_IQ_SAMPLES, n: int = 15600) -> list:
    """PCPS acquisition of every active PRN of `block` (one dict of
    `jump_scene_blocks`) over the first `n` samples (6 ms) of the block in
    the int16 I/Q file -> [{'prn', 'metric', 'doppler', 'f_carr'}]."""
    from .rx_track import acquire, iq_to_complex

    x = iq_to_complex(np.fromfile(iq_path, dtype=np.int16, count=2 * n,
                                  offset=block["first"] * nsamples * 4))
    out = []
    for c in np.flatnonzero(block["prn"] > 0):
        a = acquire(x, int(block["prn"][c]))
        out.append({"prn": int(block["prn"][c]), "metric": float(a.metric),
                    "doppler": float(a.doppler), "f_carr": float(block["f_carr"][c])})
    return out


def free_udp_ports(n: int) -> tuple:
    """`n` UDP ports of 127.0.0.1 free at the time of the call."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return tuple(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def pvt_fix(iq_path, nav_path, start: str = PVT_START) -> dict:
    """The in-repo receiver (rx_pvt.receiver_fix) on the int16 I/Q file at
    `iq_path`, a static scene at FIXTURE_LLH from `start`, given the
    scene's PRNs as candidates (only which satellites to search: ranges,
    ephemerides and time come from the samples alone) -> {'prns' (the
    candidates), 'fix_prns', 'n_sats', 'err_m' (distance from the truth),
    'max_residual_m', 't_rx_err_s' (against the transmitter's epoch clock
    at the measurement sample, g0 + 2 dt + n/fs), 'seconds' (the
    receiver's wall time)}; without a fix n_sats is 0 and the errors
    infinite."""
    from .rx_pvt import receiver_fix
    from .rx_track import iq_to_complex

    nav = read_rinex_v3(nav_path)
    g0 = scenario_start_time(nav, _parse_time(start))
    scene = ScenarioEngine(nav, PositionProvider(llh_deg=np.array(FIXTURE_LLH)), g0, 1.0)
    prns = sorted(int(p) for p in next(scene.batches(8)).prn if p > 0)
    x16 = np.fromfile(iq_path, dtype=np.int16)
    t0 = time.perf_counter()
    fix = receiver_fix(iq_to_complex(x16), prn_candidates=prns)
    out = {"prns": prns, "fix_prns": [], "n_sats": 0, "err_m": float("inf"),
           "max_residual_m": float("inf"), "t_rx_err_s": float("inf"),
           "seconds": time.perf_counter() - t0}
    if fix is None:
        return out
    sol = fix.solution
    truth = llh2xyz(np.array([FIXTURE_LLH[0] / R2D, FIXTURE_LLH[1] / R2D, FIXTURE_LLH[2]]))
    n_meas = 0.5 * (x16.size // 2)  # receiver_fix's measurement sample
    out.update(
        fix_prns=[int(p) for p in sol.prns], n_sats=int(sol.n_sats),
        err_m=float(np.linalg.norm(sol.xyz - truth)),
        max_residual_m=float(np.max(np.abs(sol.residuals))),
        t_rx_err_s=float(abs(sol.t_rx - (g0.sec + 2 * EPOCH_DT + n_meas / SAMP_RATE))),
    )
    return out


def live_pickup(nav_path, device, ports: tuple) -> dict:
    """Interactive mode at B = 1 through the port's UdpServers (on
    `ports`: position, bit relay, dt) and streaming executor at depth 1,
    0.5 s of the fixture scene on `device`: while block 1 drains, a
    position update ~110 km away (LIVE_MOVE) is sent to ports[0].  The
    reference's contract (galileo-sdr.cpp:443, a 0.2 s FIFO) is that it
    reaches the emitted samples of block 3 at the latest.  PCPS
    acquisition of the first channel's PRN reads the transmitted code
    phase from the samples -> {'blocks', 'prn', 'metric1' and
    'err1_chips' (block 1 against its transmitted code phase),
    'moved3_chips' (block 3's transmitted code phase against the
    unmoved scene's), 'rms3' (block 3's samples: the move's Doppler jump
    sends it through the direct fallback), 'fallback_blocks',
    'metric4', 'err4_chips' and 'from_stay4_chips' (block 4 against the
    moved and the unmoved code phase), 'ok' (the reference test's bars:
    metrics > 8, errors < 1 chip, moves > 20 chips, rms < 2000)}."""
    from .io.stream import StreamingSynthesizer
    from .io.udp import UdpServers
    from .rx_track import acquire, iq_to_complex

    nav = read_rinex_v3(nav_path)
    g0 = scenario_start_time(nav, _parse_time(FIXTURE_START))
    moved = np.array(LIVE_MOVE)
    servers = UdpServers(np.array(FIXTURE_LLH), ports=ports).start()
    blocks, batches = [], []

    class Collect(Sink):
        def write(self, iq) -> None:
            blocks.append(np.array(iq, copy=True).reshape(-1))

    def during_block_1(batch, stats) -> None:
        batches.append(batch)
        if stats.epochs != 1:
            return
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.sendto(struct.pack("<3d", *moved), ("127.0.0.1", ports[0]))
        deadline = time.monotonic() + 5.0
        while not np.allclose(servers.state.llh, moved):
            if time.monotonic() > deadline:
                raise RuntimeError("the UDP position update was not received")
            time.sleep(0.01)

    try:
        engine = ScenarioEngine(nav, PositionProvider(live=lambda: servers.state.llh), g0, 0.5)
        stats = StreamingSynthesizer(engine, Collect(), device=device, block_epochs=1,
                                     status_cb=during_block_1).run()
    finally:
        servers.stop()
    stay = list(ScenarioEngine(nav, PositionProvider(llh_deg=np.array(FIXTURE_LLH)), g0, 0.5).epochs())
    ch = int(np.argmax(batches[0].prn > 0))
    prn = int(batches[0].prn[ch])

    def circ(a: float, b: float) -> float:
        d = (a - b) % CA_SEQ_LEN_E1
        return float(min(d, CA_SEQ_LEN_E1 - d))

    def sent(k: int) -> float:
        return float(batches[k].code_phase0[0, ch]) % CA_SEQ_LEN_E1

    def unmoved(k: int) -> float:
        return float(stay[k].code_phase0[ch]) % CA_SEQ_LEN_E1

    a1 = acquire(iq_to_complex(blocks[0]), prn)
    a4 = acquire(iq_to_complex(blocks[3]), prn)
    out = {
        "blocks": len(blocks), "prn": prn,
        "metric1": float(a1.metric), "err1_chips": circ(a1.code_phase, sent(0)),
        "moved3_chips": circ(sent(2), unmoved(2)),
        "rms3": float(np.sqrt(np.mean(blocks[2].astype(np.float64) ** 2))),
        "fallback_blocks": stats.timer.counts.get("fallback_direct", 0),
        "metric4": float(a4.metric), "err4_chips": circ(a4.code_phase, sent(3)),
        "from_stay4_chips": circ(a4.code_phase, unmoved(3)),
    }
    out["ok"] = (out["blocks"] >= 4 and out["metric1"] > 8.0 and out["err1_chips"] < 1.0
                 and out["moved3_chips"] > 20.0 and out["rms3"] < 2000.0
                 and out["metric4"] > 8.0 and out["err4_chips"] < 1.0
                 and out["from_stay4_chips"] > 20.0)
    return out
