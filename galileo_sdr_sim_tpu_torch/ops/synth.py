"""Direct synthesis engine in plain PyTorch.

Port of galileo_sdr_sim_tpu/ops/synth.py (XLA code there, no Pallas
kernel).  Within one 0.1 s epoch both NCO phases are affine in the
sample index, so the epoch is computed data-parallel from float64-exact
host seeds per tile of TILE samples; chips and symbols are gathered by
torch indexing.

The stream uses it for epochs whose code Doppler lies outside the
factorized engine's envelope (synth_kp.MU_MAX), one epoch at a time, and
for every epoch under `--mode lut512`, the reference's integer carrier
LUT, where its output is exactly the JAX engine's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from galileo_sdr_sim_tpu.codes import carrier_lut
from galileo_sdr_sim_tpu.constants import (
    CA_SEQ_LEN_E1,
    LUT_AMPLITUDE,
    NUM_IQ_SAMPLES,
    SAMP_RATE,
)
from galileo_sdr_sim_tpu.scenario import EpochBatch

DELT = 1.0 / SAMP_RATE
TILE = 32768  # samples per seeded tile (the JAX engine's tile)
_TWO_PI_F32 = float(np.float32(2.0) * np.float32(np.pi))
_INV_SEQ_F32 = float(np.float32(1.0 / CA_SEQ_LEN_E1))


def padded_samples(nsamples: int, tile: int = TILE) -> int:
    return -(-nsamples // tile) * tile


def _pad_batch(batch: EpochBatch, B: int) -> EpochBatch:
    """Repeat the last epoch up to B rows (the output is truncated)."""
    n = batch.f_code.shape[0]
    if n > B:
        raise ValueError(f"batch has {n} epochs, more than the pad target {B}")

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], B - n, axis=0)])

    return dataclasses.replace(
        batch,
        grx_sec=pad(batch.grx_sec),
        f_carr=pad(batch.f_carr),
        f_code=pad(batch.f_code),
        code_phase0=pad(batch.code_phase0),
        carr_phase0=pad(batch.carr_phase0),
        sym_win=pad(batch.sym_win),
        pilot_win=pad(batch.pilot_win),
        gain=pad(batch.gain),
    )


def prepare_device_inputs(
    batch: EpochBatch,
    tile: int = TILE,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    *,
    device: torch.device,
) -> dict:
    """Host float64 tile seeding -> float32/int32 tensors on `device`.

    `code_cache` (a dict the caller owns) keeps the code slabs on the
    device while the channel->PRN map is unchanged."""
    if pad_epochs is not None and batch.f_code.shape[0] != pad_epochs:
        batch = _pad_batch(batch, pad_epochs)
    nt = padded_samples(nsamples, tile) // tile

    t0 = (np.arange(nt) * tile).astype(np.float64)  # (nt,)
    a = batch.f_code * DELT  # chips/sample (B, C)
    total0 = batch.code_phase0[:, :, None] + a[:, :, None] * t0  # (B, C, nt)
    w_base = np.floor(total0 / CA_SEQ_LEN_E1)
    cp_base = total0 - w_base * CA_SEQ_LEN_E1

    fc = batch.f_carr * DELT  # cycles/sample (B, C)
    carr0 = batch.carr_phase0[:, :, None] + fc[:, :, None] * t0
    carr_base = carr0 - np.trunc(carr0)

    key = batch.prn.tobytes()
    if code_cache is not None and code_cache.get("key") == key:
        codes_b, codes_c = code_cache["b"], code_cache["c"]
    else:
        codes_b = torch.from_numpy(np.ascontiguousarray(batch.codes_b)).to(device)
        codes_c = torch.from_numpy(np.ascontiguousarray(batch.codes_c)).to(device)
        if code_cache is not None:
            code_cache.update(key=key, b=codes_b, c=codes_c)

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

    return dict(
        codes_b=codes_b,
        codes_c=codes_c,
        a=dev(a, np.float32),
        fc=dev(fc, np.float32),
        cp_base=dev(cp_base, np.float32),
        w_base=dev(w_base, np.int32),
        carr_base=dev(carr_base, np.float32),
        sym_win=dev(batch.sym_win, batch.sym_win.dtype),
        pilot_win=dev(batch.pilot_win, batch.pilot_win.dtype),
    )


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x*y + z rounded ONCE, as the JAX engine's XLA lowering
    computes these affine phases (it contracts them into a fused
    multiply-add).  The float32 product is exact in float64 and so, for
    these magnitudes, is the sum, so one rounding to float32 gives the
    fused result; two float32 roundings would move chip transitions by
    one sample."""
    return (x.to(torch.float64) * y.to(torch.float64) + z.to(torch.float64)).to(torch.float32)


def synth_accum(
    codes_b: torch.Tensor,  # (C, subdiv*4092) int8 or f32
    codes_c: torch.Tensor,
    a: torch.Tensor,  # (B, C) f32 chips/sample
    fc: torch.Tensor,  # (B, C) f32 cycles/sample
    cp_base: torch.Tensor,  # (B, C, nt) f32
    w_base: torch.Tensor,  # (B, C, nt) i32
    carr_base: torch.Tensor,  # (B, C, nt) f32
    sym_win: torch.Tensor,  # (B, C, W) i8
    pilot_win: torch.Tensor,  # (B, C, W) i8
    *,
    tile: int = TILE,
    mode: str = "float",
) -> torch.Tensor:
    """Channel-summed float32 I/Q accumulator, shape (B, nt, T, 2).

    Same formulas and op order as the JAX engine; `lut512` products and
    sums are small integers, exact in any summation order."""
    if mode not in ("float", "lut512"):
        raise ValueError(f"unknown carrier mode {mode!r}")
    B, C, nt = cp_base.shape
    device = cp_base.device

    j = torch.arange(tile, dtype=torch.float32, device=device)  # (T,)
    total = _fma(a[:, :, None, None], j, cp_base[..., None])  # (B, C, nt, T)
    # wrap count within the tile (tiles can span several code periods);
    # the clip bounds the half-chip index at period edges, as in JAX
    wrap = torch.floor(total * _INV_SEQ_F32).to(torch.int32)
    rem = total - float(CA_SEQ_LEN_E1) * wrap
    subdiv = codes_b.shape[1] // CA_SEQ_LEN_E1
    icode = (float(subdiv) * rem).to(torch.int32).clamp(0, codes_b.shape[1] - 1)

    chan = torch.arange(C, device=device)[None, :, None, None]
    icode = icode.long()
    chip_b = codes_b[chan, icode]
    chip_c = codes_c[chan, icode]

    k = (w_base[..., None] + wrap).reshape(B, C, nt * tile).long()
    d = torch.gather(sym_win, 2, k).reshape(B, C, nt, tile)
    s = torch.gather(pilot_win, 2, k).reshape(B, C, nt, tile)

    m = (chip_b * d - chip_c * s).to(torch.float32)  # in {-2, 0, 2}

    phase = _fma(fc[:, :, None, None], j, carr_base[..., None])
    phase = phase - torch.trunc(phase)

    if mode == "lut512":
        cos512, sin512 = carrier_lut()
        itab = (511.0 * phase).to(torch.int32).bitwise_and(511).long()
        cosph = torch.from_numpy(cos512.astype(np.float32)).to(device)[itab]
        sinph = torch.from_numpy(sin512.astype(np.float32)).to(device)[itab]
    else:
        ang = _TWO_PI_F32 * phase
        cosph = torch.cos(ang) * float(LUT_AMPLITUDE)
        sinph = torch.sin(ang) * float(LUT_AMPLITUDE)

    i_acc = torch.sum(m * cosph, dim=1)  # (B, nt, T)
    q_acc = torch.sum(m * sinph, dim=1)
    return torch.stack([i_acc, q_acc], dim=-1)  # (B, nt, T, 2)


def quantize_iq(acc: torch.Tensor) -> torch.Tensor:
    """float32 accumulator -> interleaved int16 (B, 2*npad): the
    reference's C truncation `(short)i_acc` (galileo-sdr.cpp:536-537)."""
    return torch.trunc(acc).to(torch.int16).reshape(acc.shape[0], -1)


def synth_block(inputs: dict, tile: int = TILE, mode: str = "float") -> torch.Tensor:
    """Synthesize a block of epochs -> interleaved int16 (B, 2*npad) on
    the inputs' device."""
    with torch.inference_mode():
        acc = synth_accum(
            inputs["codes_b"],
            inputs["codes_c"],
            inputs["a"],
            inputs["fc"],
            inputs["cp_base"],
            inputs["w_base"],
            inputs["carr_base"],
            inputs["sym_win"],
            inputs["pilot_win"],
            tile=tile,
            mode=mode,
        )
        return quantize_iq(acc)
