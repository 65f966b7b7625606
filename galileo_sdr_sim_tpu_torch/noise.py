"""Calibrated AWGN injection for receiver-side validation.

The reference's validation bar is a real receiver acquiring the signal
over the air (reference README.md:72-78) — i.e. through a channel whose
thermal noise sets a received C/N0 around 40-50 dB-Hz.  The emitted
baseband stream here is noise-free, so an in-repo receiver test against
it cannot tell whether the chain has any margin.  This module adds
complex white Gaussian noise calibrated to a target **per-component
carrier-to-noise-density ratio** so the receiver chain (rx_track/rx_pvt)
can be validated at realistic and degraded C/N0 (tests/test_e2e_noise.py),
and so users can produce realistic streams (CLI `--noise-cn0`).

Calibration: each satellite contributes two components (E1B data, E1C
pilot), each a ±`amplitude` BPSK-on-BOC complex phasor (the mix is
amp*(B*d - C*s)*cis, ops/synth_kp.py), so per-component carrier power is

    C = amplitude**2            [per complex sample]

and the complex-noise variance for a target cn0 = C/N0 [dB-Hz] at
sample rate fs is

    sigma**2 = C * fs / 10**(cn0/10)     (N0 = sigma**2 / fs)

split sigma**2/2 per I/Q rail.  At the defaults (amplitude 250, fs
2.6 Msps), 45 dB-Hz gives sigma ~ 2267 — far inside int16 with the
equal-amplitude 8-channel sum at +-4000 (values are clipped anyway).
"""

from __future__ import annotations

import numpy as np

from .constants import LUT_AMPLITUDE, SAMP_RATE


def awgn_sigma(
    cn0_dbhz: float,
    amplitude: float = float(LUT_AMPLITUDE),
    fs: float = SAMP_RATE,
) -> float:
    """Complex-noise standard deviation for a per-component C/N0."""
    carrier = amplitude * amplitude
    return float(np.sqrt(carrier * fs / 10.0 ** (cn0_dbhz / 10.0)))


def add_awgn(
    iq16: np.ndarray,
    cn0_dbhz: float,
    rng: np.random.Generator | int | None = None,
    amplitude: float = float(LUT_AMPLITUDE),
) -> np.ndarray:
    """Interleaved int16 I/Q + calibrated AWGN -> interleaved int16.

    Noise is drawn per rail at sigma/sqrt(2); the sum is rounded to
    nearest and saturated to int16 like an SDR front-end ADC would.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    x = np.asarray(iq16, dtype=np.float64)
    rail = awgn_sigma(cn0_dbhz, amplitude) / np.sqrt(2.0)
    y = x + rng.normal(0.0, rail, size=x.shape)
    return np.clip(np.rint(y), -32768, 32767).astype(np.int16)


class AwgnSink:
    """Sink wrapper adding calibrated AWGN to every block on the way to
    the wrapped sink (CLI `--noise-cn0`).  Deterministic per run via the
    seeded generator."""

    def __init__(self, inner, cn0_dbhz: float, seed: int = 0):
        self.inner = inner
        self.cn0_dbhz = float(cn0_dbhz)
        self._rng = np.random.default_rng(seed)

    def write(self, block: np.ndarray) -> None:
        self.inner.write(add_awgn(block, self.cn0_dbhz, self._rng))

    def close(self) -> None:
        self.inner.close()
