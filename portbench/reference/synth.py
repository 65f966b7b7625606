"""Plain reference synthesis: one 0.1 s epoch of interleaved int16 I/Q,
worked out sample by sample from the reference scenario's epoch table.

The semantics are those of the simulator's output (the reference
simulator's sample loop, src/galileo-sdr.cpp:481-542): each visible
channel contributes

    m(n) = data[idx(n)] * d[w(n)] - pilot[idx(n)] * s[w(n)]
    I(n) += 250 m(n) cos(2 pi phi(n)),   Q(n) += 250 m(n) sin(2 pi phi(n))

with the code position cp(n) = cp0 + f_code n / fs chips, w(n) its count
of whole 4092-chip periods (the symbol of the window), idx(n) the
sub-chip of the code table (2 a chip for sine-BOC(1,1), 12 for CBOC),
phi(n) = carr0 + f_carr n / fs cycles, and the sums truncated toward zero
to int16.  Everything is computed in float64 here; `mix_dtype` computes
the carrier and the channel sum in a lower precision instead, which is
the benchmark's control, and `filter_tf32` the control's filter.

The band-limited stream (docs/bandlimit.md) is the 31.2 Msps waveform,
the twelve pointwise streams at offsets j / (12 fs) each truncated to
int16 and interleaved, filtered by the causal 385-tap Hamming-windowed
sinc (cutoff 1.3 MHz, unit DC gain) and decimated by 12 at phase 0: the
output is delayed by 192 high-rate samples, and the filter's history at
a job's start is zero.
"""

from __future__ import annotations

import numpy as np
import torch

FS = 2.6e6  # samples/s
SAMPLES = 260000  # samples an epoch
AMPLITUDE = 250.0
CODE_CHIPS = 4092
OS = 12  # band-limited oversampling: 31.2 Msps
TAPS = 385
HISTORY = (TAPS - 1) // OS  # 32 low-rate samples of each phase before an epoch


def lowpass_taps() -> np.ndarray:
    """(385,) float64 Hamming-windowed sinc, cutoff 1.3 MHz at 31.2 Msps,
    centred on tap 192, normalised to unit DC gain."""
    k = np.arange(TAPS) - (TAPS - 1) // 2
    cutoff = 0.5 / OS  # of the high rate
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * k) * np.hamming(TAPS)
    return h / h.sum()


def channel_sums(tab, data: np.ndarray, pilot: np.ndarray, n: torch.Tensor,
                 offset_s: float = 0.0, mix_dtype: torch.dtype = torch.float64) -> tuple:
    """(I, Q) float64 channel sums of epoch table `tab` at the sample
    indices `n` (float64, on the device the sums are made on), for a
    stream started `offset_s` seconds after the epoch's first sample.
    `data` and `pilot` are the model's (50, 4092 * subdiv) code tables."""
    subdiv = data.shape[1] // CODE_CHIPS
    device = n.device
    i_sum = torch.zeros(n.shape, dtype=mix_dtype, device=device)
    q_sum = torch.zeros(n.shape, dtype=mix_dtype, device=device)
    for c in np.flatnonzero(tab.prn > 0):
        prn = int(tab.prn[c])
        f_code, f_carr = float(tab.f_code[c]), float(tab.f_carr[c])
        cp = float(tab.code_phase0[c]) + f_code * offset_s + (f_code / FS) * n
        wrap = torch.floor(cp / CODE_CHIPS)
        sub = torch.floor(subdiv * (cp - CODE_CHIPS * wrap)).long().clamp(0, data.shape[1] - 1)
        wrap = wrap.long()
        d = torch.from_numpy(tab.sym_win[c].astype(np.float64)).to(device)[wrap]
        s = torch.from_numpy(tab.pilot_win[c].astype(np.float64)).to(device)[wrap]
        cb = torch.from_numpy(data[prn - 1].astype(np.float64)).to(device)[sub]
        cc = torch.from_numpy(pilot[prn - 1].astype(np.float64)).to(device)[sub]
        m = cb * d - cc * s
        phi = float(tab.carr_phase0[c]) + f_carr * offset_s + (f_carr / FS) * n
        ang = (2.0 * np.pi) * (phi - torch.floor(phi))
        m, ang = m.to(mix_dtype), ang.to(mix_dtype)
        i_sum = i_sum + m * torch.cos(ang) * AMPLITUDE
        q_sum = q_sum + m * torch.sin(ang) * AMPLITUDE
    return i_sum.to(torch.float64), q_sum.to(torch.float64)


def _interleave(i_val: torch.Tensor, q_val: torch.Tensor) -> np.ndarray:
    """float64 I and Q -> interleaved int16, truncated toward zero."""
    iq = torch.stack([torch.trunc(i_val), torch.trunc(q_val)], dim=-1).reshape(-1)
    return iq.cpu().numpy().astype(np.int16)


def pointwise_epoch(tab, data, pilot, device, mix_dtype=torch.float64) -> np.ndarray:
    """(2 * 260000,) int16: the epoch sampled pointwise at 2.6 Msps."""
    n = torch.arange(SAMPLES, dtype=torch.float64, device=device)
    return _interleave(*channel_sums(tab, data, pilot, n, mix_dtype=mix_dtype))


def bandlimited_epoch(tab, prev_tab, data, pilot, device, mix_dtype=torch.float64,
                      filter_tf32: bool = False) -> np.ndarray:
    """(2 * 260000,) int16: the band-limited epoch.  `prev_tab` is the
    table of the epoch before it in the same job, or None for a job's
    first epoch (zero history).  `filter_tf32` filters in float32 with
    cuDNN's TF32 allowed (on a GPU: the control's filter)."""
    # x_hi[12 n + j], n from -32 to 259999, I and Q: (2, 12 (N + 32))
    n_cur = torch.arange(SAMPLES, dtype=torch.float64, device=device)
    n_prev = torch.arange(SAMPLES - HISTORY, SAMPLES, dtype=torch.float64, device=device)
    legs = []
    for j in range(OS):
        offset = j / (OS * FS)
        cur = [torch.trunc(v) for v in channel_sums(tab, data, pilot, n_cur, offset, mix_dtype)]
        if prev_tab is None:
            prev = [torch.zeros(HISTORY, dtype=torch.float64, device=device)] * 2
        else:
            prev = [torch.trunc(v) for v in
                    channel_sums(prev_tab, data, pilot, n_prev, offset, mix_dtype)]
        legs.append(torch.stack([torch.cat([prev[0], cur[0]]), torch.cat([prev[1], cur[1]])]))
    x_hi = torch.stack(legs, dim=-1).reshape(2, 1, -1)  # (2, 1, 12 (N + 32))
    # out[i] = sum_k h[k] x_hi[12 i - k]: a cross-correlation with h reversed
    h = torch.from_numpy(lowpass_taps()[::-1].copy()).to(device).reshape(1, 1, TAPS)
    if filter_tf32:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            y = torch.nn.functional.conv1d(x_hi.float(), h.float(), stride=OS).double()
    else:
        y = torch.nn.functional.conv1d(x_hi, h, stride=OS)
    y = y[:, 0, :SAMPLES]
    return _interleave(y[0], y[1])
