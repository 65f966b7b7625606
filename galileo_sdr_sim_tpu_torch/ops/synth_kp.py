"""Factorized (K, p) synthesis engine: host prep and the plain PyTorch
version of the kernel.

Port of galileo_sdr_sim_tpu/ops/synth_kp.py (host seeding) and of the
host halves of ops/synth_kp_pallas.py (`_window_anchors`,
`_pack_pm1_bits`).  Each 0.1 s epoch of 260000 samples is laid out on a
grid n = 1300*K + p (fs / chip rate = 1300/1023 exactly); see the JAX
module's docstring for the derivation.

`prepare_kp_inputs` computes every operand the kernel reads on the host
in numpy (float64 seeds rounded to float32 exactly as the JAX package
rounds them) and moves all per-epoch operands to the device in ONE
host-to-device copy.  `synth_kp_packed_ref` is the plain PyTorch
version of the kernel (ops/synth_kp_cuda.py): the CPU engine, and the
reference the kernel is held to on the card.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from galileo_sdr_sim_tpu.constants import LUT_AMPLITUDE, NUM_IQ_SAMPLES, SAMP_RATE
from galileo_sdr_sim_tpu.scenario import EpochBatch

from .synth import _pad_batch

DELT = 1.0 / SAMP_RATE
P_GRID = 1300  # samples per grid row: fs/chip_rate = 1300/1023 exactly
ROWS = 8  # BOC sequence rows: 8184 = 8*1023
COLS = 1023
K_EPOCH = NUM_IQ_SAMPLES // P_GRID  # 200
W_PACK = 32  # 2 codes x 2 shifts x 8 rows
J_RS = 5  # resampled-table taps: e'(p) in {-2..2}
W_RS = J_RS * W_PACK  # 160 rows: j*32 + code*16 + shift*8 + rho
T_RS = 11904  # table columns >= max o (10399) + 1408
# code-Doppler envelope of the delta/tap machinery (|f_code/1000 - 1023|);
# epochs outside it go to the direct engine (ops/synth.py)
MU_MAX = 3e-3
SYM_BITS = 32  # symbol windows are bit-packed into one int32

# per-(epoch, channel) operands of the kernel, in the order of the single
# host-to-device buffer; the int32 ones are listed in INT_OPERANDS
SCALAR_OPERANDS = (
    "cp0", "two_a", "mu", "g0", "o", "r", "carr0", "fc", "fc_k",
    "sym_bits", "pil_bits",
)
INT_OPERANDS = frozenset(("o", "sym_bits", "pil_bits"))

_F32 = np.float32
_TWO_PI_F32 = float(_F32(2.0 * np.pi))
_NPER_F32 = _F32(ROWS * COLS)
_INV_NPER_F32 = float(_F32(1.0) / _NPER_F32)
_S_RATIO_F32 = float(_F32(COLS / P_GRID))


def mu_in_envelope(f_code: np.ndarray) -> bool:
    """True when every epoch-channel's code-Doppler drift fits the
    factorized engine's delta/tap design envelope."""
    return bool(np.abs(f_code / 1000.0 - COLS).max() <= MU_MAX)


def _pack_codes_rs(codes_b: np.ndarray, codes_c: np.ndarray) -> np.ndarray:
    """(C, 8184) x2 int8 -> (C, 160, 11904) int8 staircase-pre-resampled
    window table:

        vpack_rs[c, j*32 + code*16 + shift*8 + rho, t]
            = code_flat[c, (1023*rho + S(t) + (j-2) + shift) % 8184]

    with S(t) = floor(1023*t/1300).  One column slice at t = o + p holds
    the five candidate taps of sample p (see the JAX original)."""
    C = codes_b.shape[0]
    s_rs = (COLS * np.arange(T_RS)) // P_GRID
    out = np.zeros((C, W_RS, T_RS), np.int8)
    for j in range(J_RS):
        for ci, flat in enumerate((codes_b, codes_c)):
            for shift in range(2):
                for r in range(ROWS):
                    src = (COLS * r + s_rs + (j - 2) + shift) % (ROWS * COLS)
                    out[:, j * W_PACK + ci * 16 + shift * 8 + r, :] = flat[:, src]
    return out


def compact_channels(batch: EpochBatch, multiple: int = 8) -> EpochBatch:
    """Drop idle channel slots, keeping a channel count that is a multiple
    of `multiple`; idle rows contribute nothing to the channel sum."""
    active = np.flatnonzero(batch.prn > 0)
    n = max(multiple, -(-len(active) // multiple) * multiple)
    if n >= len(batch.prn):
        return batch
    keep = np.concatenate(
        [active, np.flatnonzero(batch.prn <= 0)[: n - len(active)]]
    )
    return dataclasses.replace(
        batch,
        prn=batch.prn[keep],
        f_carr=batch.f_carr[:, keep],
        f_code=batch.f_code[:, keep],
        code_phase0=batch.code_phase0[:, keep],
        carr_phase0=batch.carr_phase0[:, keep],
        sym_win=batch.sym_win[:, keep],
        pilot_win=batch.pilot_win[:, keep],
        gain=batch.gain[:, keep],
        codes_b=batch.codes_b[keep],
        codes_c=batch.codes_c[keep],
    )


def packed_to_iq16(packed: np.ndarray) -> np.ndarray:
    """(B, n_k, 1300) int32 packed I/Q -> (B, 2*n_k*1300) interleaved
    int16 (a view when contiguous)."""
    if sys.byteorder != "little":
        raise RuntimeError("the packed I/Q view needs a little-endian host")
    arr = np.ascontiguousarray(packed)
    return arr.view(np.int16).reshape(arr.shape[0], -1)


def _window_anchors(cp0: np.ndarray, mu: np.ndarray) -> tuple:
    """(B, C) float32 cp0/mu -> the window anchors of the table slice:
    g0 (f32), o = ceil(1300*start/1023) and r = 1023*o - 1300*start
    (int32), start = g0 mod 8184.  Same float32 formulas as the JAX
    wrapper; every value is an exact integer below 2^24."""
    g0 = np.floor(_F32(2.0) * cp0) + np.where(mu < 0.0, _F32(-1.0), _F32(0.0))
    g0 = g0.astype(np.float32)
    start = np.mod(g0, _NPER_F32).astype(np.int32)
    o = (P_GRID * start + (COLS - 1)) // COLS
    r = COLS * o - P_GRID * start
    return g0, o.astype(np.int32), r.astype(np.int32)


def _pack_pm1_bits(win: np.ndarray) -> np.ndarray:
    """(B, C, W<=32) +-1 window -> (B, C) int32 bit mask (bit k set <=>
    entry k is -1).  The mask keeps signs only, so a window that carries
    amplitude is refused (always checked here; the JAX guard is skipped
    under jit)."""
    w = np.asarray(win)
    W = w.shape[-1]
    if W > SYM_BITS:
        raise ValueError(f"symbol window of {W} entries exceeds {SYM_BITS} bits")
    mx = float(np.max(np.abs(w))) if w.size else 0.0
    if mx > 1.0 + 1e-6:
        raise ValueError(
            f"symbol window carries amplitude (max |w| = {mx}); the bit-pack "
            "would drop it"
        )
    weights = (np.uint64(1) << np.arange(W, dtype=np.uint64)).astype(np.uint32)
    bits = (w < 0).astype(np.uint32)
    packed = np.sum(bits * weights, axis=-1, dtype=np.uint32)
    return packed.view(np.int32)


def kernel_operands(host: dict) -> dict:
    """Seeded float32 operands (the JAX `prepare_kp_inputs` host dict:
    cp0, two_a, mu, carr0, fc, fc_k, sym_win, pilot_win) -> the kernel's
    per-(epoch, channel) operands, all (B, C) float32 or int32 numpy."""
    cp0 = np.asarray(host["cp0"], np.float32)
    mu = np.asarray(host["mu"], np.float32)
    g0, o, r = _window_anchors(cp0, mu)
    ops = {
        "cp0": cp0,
        "two_a": np.asarray(host["two_a"], np.float32),
        "mu": mu,
        "g0": g0,
        "o": o,
        "r": r.astype(np.float32),  # the kernel compares it in float32
        "carr0": np.asarray(host["carr0"], np.float32),
        "fc": np.asarray(host["fc"], np.float32),
        "fc_k": np.asarray(host["fc_k"], np.float32),
        "sym_bits": _pack_pm1_bits(host["sym_win"]),
        "pil_bits": _pack_pm1_bits(host["pilot_win"]),
    }
    return ops


def operands_to_device(ops: dict, device: torch.device) -> dict:
    """Move the (B, C) operands to `device` in one host-to-device copy
    (pinned and non-blocking on a GPU) and return views into it."""
    B, C = ops["cp0"].shape
    shape = (len(SCALAR_OPERANDS), B, C)
    if device.type == "cuda":
        staging = torch.empty(shape, dtype=torch.int32, pin_memory=True)
    else:
        staging = torch.empty(shape, dtype=torch.int32)
    buf = staging.numpy()
    for i, name in enumerate(SCALAR_OPERANDS):
        arr = ops[name]
        want = np.int32 if name in INT_OPERANDS else np.float32
        if arr.dtype != want or arr.shape != (B, C):
            raise ValueError(f"operand {name}: {arr.dtype}{arr.shape}, want {want}")
        buf[i] = arr.view(np.int32)
    dev = staging.to(device, non_blocking=True)
    return {
        name: dev[i] if name in INT_OPERANDS else dev[i].view(torch.float32)
        for i, name in enumerate(SCALAR_OPERANDS)
    }


def prepare_kp_inputs(
    batch: EpochBatch,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    *,
    device: torch.device,
    apply_gain: bool = False,
) -> dict:
    """Host float64 seeding -> the kernel's operands on `device`.

    Seeds as galileo_sdr_sim_tpu.ops.synth_kp.prepare_kp_inputs does
    (channels compacted, epochs padded to `pad_epochs`); the window
    table `vpack_rs` (C, 160, 11904) int8 is cached on the device in
    `code_cache` while the channel->PRN map and table width hold.
    nsamples must be a multiple of 8*1300 = 10400."""
    if apply_gain:
        raise NotImplementedError(
            "--apply-gain is not ported yet (ROADMAP queue 1 item 8, "
            "kernel queue item 4)"
        )
    batch = compact_channels(batch)
    if pad_epochs is not None and batch.f_code.shape[0] != pad_epochs:
        batch = _pad_batch(batch, pad_epochs)
    if nsamples % (ROWS * P_GRID) != 0:
        raise ValueError(f"nsamples={nsamples} is not a multiple of {ROWS * P_GRID}")
    width = batch.codes_b.shape[1]
    if width != ROWS * COLS:
        raise NotImplementedError(
            f"code tables of width {width}: only the sine-BOC(1,1) half-chip "
            f"tables ({ROWS * COLS}) are ported; CBOC is ROADMAP queue 1 "
            "item 8 (kernel queue item 5)"
        )

    a = batch.f_code * DELT  # chips/sample, float64
    mu = 2.0 * a * P_GRID - COLS  # half-chips of drift per K step
    fc = batch.f_carr * DELT  # cycles/sample
    fc_k = fc * P_GRID
    fc_k = fc_k - np.floor(fc_k)

    key = (batch.prn.tobytes(), width)
    if code_cache is not None and code_cache.get("key") == key:
        vpack_rs = code_cache["vpack_rs"]
    else:
        vpack_rs = torch.from_numpy(
            _pack_codes_rs(batch.codes_b, batch.codes_c)
        ).to(device)
        if code_cache is not None:
            code_cache.update(key=key, vpack_rs=vpack_rs)

    host = dict(
        cp0=np.asarray(batch.code_phase0, np.float32),  # (B, C) [chips]
        two_a=np.asarray(2.0 * a, np.float32),  # half-chips/sample
        mu=np.asarray(mu, np.float32),
        carr0=np.asarray(batch.carr_phase0, np.float32),
        fc=np.asarray(fc, np.float32),
        fc_k=np.asarray(fc_k, np.float32),
        sym_win=batch.sym_win.astype(np.float32),  # (B, C, 32) +-1
        pilot_win=batch.pilot_win.astype(np.float32),
    )
    out = operands_to_device(kernel_operands(host), device)
    out["vpack_rs"] = vpack_rs
    return out


def _cos_sin(ang: torch.Tensor) -> tuple:
    """float32 cos/sin evaluated in float64 and rounded once to float32.

    torch's float32 CPU sin/cos return last bits that depend on how a
    multi-threaded loop is split (vector body vs scalar tail), so the
    same inputs could give different outputs from run to run; rounding
    the float64 value is deterministic and within 1/2 ulp."""
    a = ang.to(torch.float64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def synth_kp_packed_ref(inputs: dict, n_k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, n_k, 1300) int32 packed
    I/Q (I in the low 16 bits, Q in the high) on the inputs' device.

    Follows `_kernel_v5` (galileo_sdr_sim_tpu/ops/synth_kp_pallas.py) for
    sine-BOC, emit="i32pack", no gain: the per-(c, p) prologue, then the
    (K, p) main loop vectorized over (B, K, p), with channels added in
    ascending order in float32 (never a reduction over the channel axis:
    its order is the library's choice and lands an ulp off the kernel's
    sequential adds, which flips trunc() at integer ties)."""
    if n_k % ROWS != 0 or n_k // ROWS + 2 > SYM_BITS:
        raise ValueError(f"n_k={n_k}: need a multiple of {ROWS} with n_k/8 + 2 <= 32")
    cp0 = inputs["cp0"]
    device = cp0.device
    B, C = cp0.shape
    n_kap = n_k // ROWS
    f32 = torch.float32
    with torch.inference_mode():
        pp = torch.arange(P_GRID, dtype=f32, device=device)
        col = lambda k: inputs[k][..., None]  # noqa: E731  (B, C, 1)

        # --- prologue: per-(b, c, p) geometry --------------------------
        mu = col("mu")
        phi = 2.0 * col("cp0") + col("two_a") * pp
        gb = torch.floor(phi) + torch.where(mu < 0.0, -1.0, 0.0)
        psi = phi - gb
        gbm = gb - float(_NPER_F32) * torch.floor(gb * _INV_NPER_F32)
        w8 = (gb >= float(_NPER_F32)).to(f32)
        s_p = torch.floor(pp * _S_RATIO_F32)
        m_p = float(COLS) * pp - float(P_GRID) * s_p
        kap_p = (m_p + col("r") >= float(P_GRID)).to(f32)
        e2 = (gb - col("g0")) - s_p - kap_p
        ph_p = col("carr0") + col("fc") * pp
        ph_p = ph_p - torch.floor(ph_p)
        ang_p = _TWO_PI_F32 * ph_p
        cpr, cpi = _cos_sin(ang_p)

        # 5-tap select from the window vpack_rs[c, :, o + p]
        j = (e2 + 2.0).to(torch.int64)  # (B, C, P)
        valid = ((j >= 0) & (j < J_RS)).to(f32)[:, :, None, :]
        rows = j.clamp(0, J_RS - 1)[:, :, None, :] * W_PACK + torch.arange(
            W_PACK, device=device
        )[None, None, :, None]  # (B, C, 32, P)
        cols = (
            inputs["o"].to(torch.int64)[..., None]
            + torch.arange(P_GRID, device=device)
        )[:, :, None, :]  # (B, C, 1, P)
        chan = torch.arange(C, device=device)[None, :, None, None]
        sel = inputs["vpack_rs"][chan, rows, cols].to(f32) * valid
        a0b, a1b = sel[:, :, 0:8], sel[:, :, 8:16]  # (B, C, rho, P)
        a0c, a1c = sel[:, :, 16:24], sel[:, :, 24:32]
        dab, dac = a1b - a0b, a1c - a0c
        rho = torch.arange(ROWS, dtype=f32, device=device)
        thr = float(COLS) * (float(ROWS) - rho)[None, None, :, None]
        b0 = (gbm[:, :, None, :] >= thr).to(f32)
        b1 = (gbm[:, :, None, :] + 1.0 >= thr).to(f32)
        db = b1 - b0

        # --- main loop: K = 8*kap + rho, channels ascending ------------
        k8 = torch.arange(n_k, dtype=f32, device=device).reshape(n_kap, ROWS)
        kap = torch.arange(n_kap, dtype=torch.int32, device=device)

        def sym(words, c, shift):
            bit = (words[:, c, None] >> (kap + shift)[None, :]) & 1  # (B, kap)
            return (1.0 - 2.0 * bit.to(f32))[:, :, None, None]

        acc_i = acc_q = None
        for c in range(C):
            t_kp = psi[:, c, None, None, :] + (
                inputs["mu"][:, c, None, None] * k8
            )[..., None]  # (B, kap, rho, P)
            delta = torch.floor(t_kp)
            chip_b = a0b[:, c, None] + delta * dab[:, c, None]
            chip_c = a0c[:, c, None] + delta * dac[:, c, None]
            bsel = b0[:, c, None] + delta * db[:, c, None]
            w8c = w8[:, c, None, None, :]
            d0, d1, d2 = (sym(inputs["sym_bits"], c, s) for s in range(3))
            s0, s1, s2 = (sym(inputs["pil_bits"], c, s) for s in range(3))
            d_lo = d0 + w8c * (d1 - d0)  # (B, kap, 1, P)
            d_df = (d1 + w8c * (d2 - d1)) - d_lo
            s_lo = s0 + w8c * (s1 - s0)
            s_df = (s1 + w8c * (s2 - s1)) - s_lo
            d_val = d_lo + bsel * d_df
            s_val = s_lo + bsel * s_df
            m = chip_b * d_val - chip_c * s_val
            ph_k = inputs["fc_k"][:, c, None, None] * k8  # (B, kap, rho)
            ph_k = ph_k - torch.floor(ph_k)
            ang_k = _TWO_PI_F32 * ph_k
            ckr, cki = _cos_sin(ang_k)
            ckr, cki = ckr[..., None], cki[..., None]
            cpr_c = cpr[:, c, None, None, :]
            cpi_c = cpi[:, c, None, None, :]
            cis_r = ckr * cpr_c - cki * cpi_c
            cis_i = ckr * cpi_c + cki * cpr_c
            v_i = m * cis_r
            v_q = m * cis_i
            acc_i = v_i if c == 0 else acc_i + v_i
            acc_q = v_q if c == 0 else acc_q + v_q

        amp = float(LUT_AMPLITUDE)
        ii = torch.trunc(amp * acc_i).to(torch.int32)
        qq = torch.trunc(amp * acc_q).to(torch.int32)
        packed = (ii & 0xFFFF) | (qq << 16)
        return packed.reshape(B, n_k, P_GRID)
