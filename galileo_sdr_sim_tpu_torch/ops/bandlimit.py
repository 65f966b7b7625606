"""Band-limited CBOC output mode (--bandlimit) in PyTorch.

Port of galileo_sdr_sim_tpu/ops/bandlimit.py.  The 31.2 Msps CBOC
waveform x_hi[12n + j] is twelve 2.6 Msps pointwise streams x_j at
sub-sample offsets t_j = j / (12 fs).  A block's twelve phase-shifted
copies go on one epoch axis (`phase_stack`), so the twelve streams are
one host prep and one call of the factorized kernel (emit="int16") of
12 x B epochs: an epoch's output depends on its own operands and the
shared code table alone, so the call writes the bytes of twelve calls of
B epochs, already in the (12, B, 2N) layout the filter reads.  The
decimate-by-12 of conv(x_hi, h) is, in polyphase form, one
12-input-channel convolution over the stacked phase streams; an overlap
state of the trailing 2*V0 = 32 low-rate samples per phase carries
across blocks, so the stream is seamless at block edges and delayed by
V0 = 16 samples.  The filter is 385 taps of Hamming-windowed sinc,
cutoff 1.3 MHz at 31.2 Msps, unit DC gain.

The numpy parts (taps, polyphase kernel, phase shift) are copies of the
JAX module's, which imports JAX.  The JAX package runs the filter as an
XLA convolution, not a Pallas kernel, so here it is
`torch.nn.functional.conv1d`, in full float32: on a GPU cuDNN would
otherwise run float32 convolutions in TF32 (a 10-bit mantissa), which
moves outputs by several LSB.

Spans (profiling.span; nothing without an installed Timer): `launch`
around the block's one kernel call and `filter` around the whole filter
(1 a block each); the host prep opens its own `seed` and `h2d` (1 a
block).  Called from the stream they are the sections
`host_prep+dispatch/launch` and so on.  On a GPU `filter` is not
dispatch alone: the weights' pageable host-to-device copy inside it
waits for the block's kernel pair on the stream.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import NUM_IQ_SAMPLES, SAMP_RATE
from ..profiling import span
from ..scenario import EpochBatch
from .synth import _pad_batch
from .synth_kp import CBOC_WIDTH, P_GRID, prepare_kp_inputs
from .synth_kp_cuda import synth_kp_int16

OS = 12  # oversampling factor: sc6 sub-chip grid
TPP = 32  # taps per polyphase branch
M = OS * TPP + 1  # 385 total taps
D = M // 2  # group delay (high-rate samples)
V0 = 16  # polyphase tap window [-V0, V0] (low-rate)


def lowpass_taps() -> np.ndarray:
    """(M,) Hamming-windowed sinc, cutoff fs_lo/2, unit DC gain."""
    k = np.arange(M) - D
    fc = 0.5 / OS  # of the high rate
    h = 2 * fc * np.sinc(2 * fc * k) * np.hamming(M)
    return h / h.sum()


@functools.lru_cache(maxsize=1)
def polyphase_kernel() -> np.ndarray:
    """(1, OS, 2*V0+1) conv weights: K[0, j, t] = h[12*(V0 - t) + D - j].

    y[i] = sum_j sum_v h[12 v + D - j] * x_j[i - v]; with the overlap
    state prepending 2*V0 samples and a VALID conv, out[i] =
    sum_t K[0, j, t] * x_j[i + t - 2*V0], so the emitted stream is y
    delayed by V0 low-rate samples."""
    h = lowpass_taps()
    K = np.zeros((1, OS, 2 * V0 + 1), np.float32)
    for j in range(OS):
        for t in range(2 * V0 + 1):
            idx = OS * (V0 - t) + D - j
            if 0 <= idx < M:
                K[0, j, t] = h[idx]
    return K


def phase_shift_batch(batch: EpochBatch, j: int) -> EpochBatch:
    """Epoch batch advanced by t_j = j/(12 fs): the j-th polyphase leg
    x_j[n] = x_hi[12 n + j].  Exact in float64 host seeds."""
    tj = j / (OS * SAMP_RATE)
    return dataclasses.replace(
        batch,
        code_phase0=batch.code_phase0 + batch.f_code * tj,
        carr_phase0=np.mod(batch.carr_phase0 + batch.f_carr * tj, 1.0),
    )


def phase_stack(batch: EpochBatch) -> EpochBatch:
    """The OS phase-shifted copies of a B-epoch batch on one epoch axis:
    epoch j*B + b is epoch b of `phase_shift_batch(batch, j)`, bit for
    bit.  The code rows and the PRN map are the batch's own, so the code
    cache's key is too."""
    shifts = [phase_shift_batch(batch, j) for j in range(OS)]

    def tiled(x: np.ndarray) -> np.ndarray:
        return np.concatenate([x] * OS)

    return dataclasses.replace(
        batch,
        grx_sec=tiled(batch.grx_sec),
        f_carr=tiled(batch.f_carr),
        f_code=tiled(batch.f_code),
        code_phase0=np.concatenate([s.code_phase0 for s in shifts]),
        carr_phase0=np.concatenate([s.carr_phase0 for s in shifts]),
        sym_win=tiled(batch.sym_win),
        pilot_win=tiled(batch.pilot_win),
        gain=tiled(batch.gain),
    )


def initial_state(device: torch.device) -> torch.Tensor:
    """(2, OS, 2*V0) float32 overlap history (I/Q x phase x samples)."""
    return torch.zeros((2, OS, 2 * V0), dtype=torch.float32, device=device)


def _conv_f32(ext: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """VALID 1-D convolution (cross-correlation, as XLA's) in full
    float32 on any device."""
    if ext.device.type == "cuda":
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(ext, kern)
    return F.conv1d(ext, kern)


def filter_block(stacked: torch.Tensor, hist: torch.Tensor, n_real: int) -> tuple:
    """stacked (OS, B, 2N) int16 phase streams -> ((B, 2N) int16
    band-limited interleaved I/Q, new overlap state), on their device.

    `n_real` is the count of real epochs in the (padded) block: the
    overlap state is taken at the last real sample, so a partial block
    hands a seamless history to the next one."""
    n_os, B, two_n = stacked.shape
    N = two_n // 2
    with span("filter"), torch.inference_mode():
        x = stacked.to(torch.float32)
        i_ph = x[:, :, 0::2].reshape(n_os, -1)  # (OS, L) time-ordered over B*N
        q_ph = x[:, :, 1::2].reshape(n_os, -1)
        ext = torch.cat([hist, torch.stack([i_ph, q_ph])], dim=-1)  # (2, OS, L + 2*V0)
        kern = torch.from_numpy(polyphase_kernel()).to(ext.device)
        y = _conv_f32(ext, kern)  # (2, 1, L)
        new_hist = ext[:, :, n_real * N : n_real * N + 2 * V0].clone()
        yi = torch.trunc(y[0, 0]).reshape(B, -1)
        yq = torch.trunc(y[1, 0]).reshape(B, -1)
        out = torch.stack([yi, yq], dim=-1).reshape(B, two_n).to(torch.int16)
    return out, new_hist


def synth_phases(
    batch: EpochBatch,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    apply_gain: bool = False,
    *,
    device: torch.device,
) -> torch.Tensor:
    """The 12 phase streams of a 12-subdiv CBOC batch -> (OS, B, 2N)
    int16 on `device`, B the padded epochs: the batch padded, its phase
    stack (`phase_stack`, compacted and seeded by one `prepare_kp_inputs`)
    and one kernel call (emit="int16") of OS x B epochs, whose output
    this is a view of.  The gain weights of the stack equal the batch's:
    its peak is the batch's peak."""
    if batch.codes_b.shape[1] != CBOC_WIDTH:
        raise ValueError("--bandlimit needs the CBOC 12-grid signal model")
    if pad_epochs is not None and batch.f_code.shape[0] != pad_epochs:
        batch = _pad_batch(batch, pad_epochs)
    inputs = prepare_kp_inputs(
        phase_stack(batch),
        nsamples,
        code_cache=code_cache,
        apply_gain=apply_gain,
        device=device,
    )
    with span("launch"):
        out = synth_kp_int16(inputs, n_k=nsamples // P_GRID)
    return out.view(OS, batch.f_code.shape[0], -1)


def synth_block_cboc_bandlimited(
    batch: EpochBatch,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    state: torch.Tensor | None = None,
    apply_gain: bool = False,
    *,
    device: torch.device,
) -> tuple:
    """One epoch block of the band-limited CBOC stream -> ((B, 2N) int16
    on `device`, new state)."""
    if state is None:
        state = initial_state(device)
    stacked = synth_phases(
        batch, nsamples, pad_epochs, code_cache, apply_gain, device=device
    )
    return filter_block(stacked, state, batch.f_code.shape[0])
