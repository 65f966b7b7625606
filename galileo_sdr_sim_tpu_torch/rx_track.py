"""Receiver-side acquisition and tracking over the emitted int16 stream.

The reference validates its output by running a full software receiver
(GNSS-SDR: PCPS acquisition -> VEML tracking -> telemetry decode -> PVT,
reference gnss-sdr_Galileo_E1_ishort.conf:36-100).  This module is the
in-repo equivalent of the acquisition + tracking stages so the whole
acceptance chain (through the PVT fix in rx_pvt.py) runs in CI using
only the emitted samples — no transmitter metadata.

Design (classic receiver, simplified for the noise-free CI stream):

* PCPS acquisition: FFT circular correlation over one 4 ms code period,
  coarse (250 Hz) then fine (25 Hz) Doppler grid; two window offsets so
  a symbol sign flip inside the window cannot null the peak.
* Tracking in ~40 ms blocks: carrier wipe from an NCO model (phase
  continuous across blocks), per-code-period prompt correlations for
  data (E1B) and pilot (E1C) accumulated by *global period index* so
  symbols split across block edges re-join exactly.
* Carrier loop: squared-prompt (Costas) phase-slope discriminator per
  block, |pull-in| ~60 Hz.
* Code loop: carrier-aided NCO (f_code = 1.023e6 + fd/1540, the same
  relation the transmitter uses, gal-sig.cpp:318-323) plus a periodic
  multi-lag correlation with a two-line triangle-apex fit -- the BOC(1,1)
  sampled autocorrelation is linear within |tau| < 0.25 chips, so the
  apex locates code phase to ~1e-3 chips (~0.3 m) without a VE/VL bank.
* Measurement output: a piecewise-linear unwrapped code-phase model
  cp_u(n) (chips since the track's period 0) -- one pseudorange per
  requested sample index, plus per-period complex prompts for the
  decode stage.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .codes import boc_chips
from .constants import (
    CA_SEQ_LEN_E1,
    CARR_TO_CODE_E1,
    CODE_FREQ_E1,
    SAMP_RATE,
)

N_PER = 10400  # samples per 4 ms code period at 2.6 Msps (nominal)
TWO_PI = 2.0 * np.pi


def iq_to_complex(iq: np.ndarray) -> np.ndarray:
    """Interleaved int16 I/Q -> complex128 baseband."""
    iq = np.asarray(iq).reshape(-1)
    return iq[0::2].astype(np.float64) + 1j * iq[1::2].astype(np.float64)


# --- acquisition -------------------------------------------------------


@dataclass
class Acquisition:
    prn: int
    metric: float  # peak / median of the correlation magnitude
    doppler: float  # carrier Doppler estimate [Hz]
    code_phase: float  # code phase at sample 0 [chips, 0..4092)


def _pcps(xw: np.ndarray, rep_fft: np.ndarray, t: np.ndarray, dopplers):
    best = (0.0, 0.0, 0)
    for fd in dopplers:
        xc = xw * np.exp(-2j * np.pi * fd * t)
        corr = np.abs(np.fft.ifft(np.fft.fft(xc) * rep_fft))
        m = corr.max() / max(np.median(corr), 1e-12)
        if m > best[0]:
            best = (m, fd, int(corr.argmax()))
    return best


def _pcps_noncoh(windows: np.ndarray, rep_fft: np.ndarray, t: np.ndarray,
                 dopplers):
    """Non-coherently accumulated PCPS: sum |corr|^2 over M code-period
    windows per Doppler cell.  The accumulation buys ~sqrt(M) detection
    margin at low C/N0 where a single 4 ms coherent window is blind
    (~<47 dB-Hz for a clean peak/median >= 8) — the same coherent x
    non-coherent structure as GNSS-SDR's PCPS acquisition blocks
    (reference gnss-sdr_Galileo_E1_ishort.conf:42-51)."""
    best = (0.0, 0.0, 0)
    for fd in dopplers:
        wipe = np.exp(-2j * np.pi * fd * t)
        pwr = np.zeros(N_PER)
        for xw in windows:
            corr = np.fft.ifft(np.fft.fft(xw * wipe) * rep_fft)
            pwr += corr.real**2 + corr.imag**2
        m = pwr.max() / max(np.median(pwr), 1e-12)
        if m > best[0]:
            best = (m, fd, int(pwr.argmax()))
    return best


def acquire(
    x: np.ndarray,
    prn: int,
    doppler_span: float = 4000.0,
    n0: int = 0,
    n_noncoh: int = 1,
    model=None,
) -> Acquisition:
    """PCPS acquisition of one PRN on the E1B component.

    n_noncoh=1 (noise-free streams): correlates one code period at two
    window offsets (0 and N_PER/2) so a data-symbol transition cannot
    null both, mirroring GNSS-SDR's non-coherent PCPS (conf:42-51 uses
    cboc=false, i.e. the same sine-BOC replica this uses).

    n_noncoh=M>1 (noisy streams): accumulates |corr|^2 over M
    consecutive code periods per Doppler cell instead (symbol flips
    cannot null a power sum; the metric is peak/median of the summed
    power map, whose noise floor tightens ~sqrt(M)).
    """
    t = np.arange(N_PER) / SAMP_RATE
    # model-matched replica: default sine-BOC(1,1) half-chips (what the
    # GNSS-SDR eval config uses, cboc=false); pass a signal model (e.g.
    # models.cboc.E1_CBOC) to correlate against its true pointwise
    # waveform instead (+0.4 dB on a CBOC stream)
    if model is None:
        sub, rep_src = 2, boc_chips("E1B")[prn - 1]
    else:
        sub, rep_src = model.code_subdiv, model.data_codes[prn - 1]
    idx = np.floor(t * sub * CODE_FREQ_E1).astype(np.int64) % (
        sub * CA_SEQ_LEN_E1
    )
    rep = rep_src[idx].astype(np.float64)
    rep_fft = np.conj(np.fft.fft(rep))

    # 100 Hz grid: coarse error <= 50 Hz, inside the +-125 Hz pull-in of
    # the squared-prompt FFT fine stage in track() (a 25 Hz "fine" PCPS
    # stage on a 4 ms window is unreliable -- the Doppler main lobe is
    # 250 Hz wide -- and a 60 Hz error false-locks the squaring loop at
    # its 62.5 Hz alias, so the fine stage lives in track() instead).
    coarse = np.arange(-doppler_span, doppler_span + 1.0, 100.0)
    if n_noncoh > 1:
        windows = np.stack(
            [x[n0 + w * N_PER : n0 + (w + 1) * N_PER] for w in range(n_noncoh)]
        )
        m, fd, lag = _pcps_noncoh(windows, rep_fft, t, coarse)
        w0 = n0
    else:
        best = (0.0, 0.0, 0, 0)  # metric, fd, lag, window start
        for w0 in (n0, n0 + N_PER // 2):
            m, fd, lag = _pcps(x[w0 : w0 + N_PER], rep_fft, t, coarse)
            if m > best[0]:
                best = (m, fd, lag, w0)
        m, fd, lag, w0 = best

    # corr[m] = sum_n x[w0+n+m] rep[n]: sample w0+lag carries code phase 0.
    f_code = CODE_FREQ_E1 + fd * CARR_TO_CODE_E1
    cp0 = (-(w0 + lag) * f_code / SAMP_RATE) % CA_SEQ_LEN_E1
    return Acquisition(prn=prn, metric=float(m), doppler=float(fd), code_phase=float(cp0))


# --- tracking ----------------------------------------------------------


@dataclass
class TrackResult:
    """Per-satellite tracking output.

    The unwrapped code-phase model counts chips from the start of the
    track's *period 0* (the code-period boundary at or before sample 0),
    so `chips_at(n) / 4092` is the fractional period index at sample n.
    """

    prn: int
    doppler: float
    # piecewise model: for n in [n_start[b], n_start[b+1]):
    #   cp_u(n) = cp_start[b] + f_code[b] * (n - n_start[b]) / fs
    n_start: np.ndarray = field(default_factory=lambda: np.empty(0))
    cp_start: np.ndarray = field(default_factory=lambda: np.empty(0))
    f_code: np.ndarray = field(default_factory=lambda: np.empty(0))
    # per-global-period complex prompts (index = period number)
    d_prompt: np.ndarray = field(default_factory=lambda: np.empty(0, complex))
    p_prompt: np.ndarray = field(default_factory=lambda: np.empty(0, complex))
    n_count: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    # diagnostics: (block index, applied code correction [chips])
    err_hist: list = field(default_factory=list)

    def chips_at(self, n: float) -> float:
        """Unwrapped chips at (fractional) sample index n."""
        b = int(np.searchsorted(self.n_start, n, side="right")) - 1
        b = max(0, min(b, len(self.n_start) - 1))
        return float(
            self.cp_start[b] + self.f_code[b] * (n - self.n_start[b]) / SAMP_RATE
        )


def _apex(taus: np.ndarray, r: np.ndarray) -> float:
    """Two-line triangle-apex fit: intersect the best-fit lines through
    the points left and right of the correlation maximum."""
    i = int(np.argmax(r))
    left = slice(max(0, i - 2), i)
    right = slice(i + 1, min(len(r), i + 3))
    if left.stop - left.start < 2 or right.stop - right.start < 2:
        return float(taus[i])
    al, bl = np.polyfit(taus[left], r[left], 1)
    ar, br = np.polyfit(taus[right], r[right], 1)
    if abs(al - ar) < 1e-12:
        return float(taus[i])
    return float((br - bl) / (al - ar))


def _fine_freq(prompts: np.ndarray) -> float:
    """Residual carrier frequency from squared per-period prompts.

    FFT of p_k^2 (BPSK removed) sampled at the 250 Hz symbol rate:
    unambiguous over +-62.5 Hz of carrier error, resolution ~1 Hz with
    zero padding -- bridges the 100 Hz acquisition grid to the +-62.5 Hz
    pull-in of the per-block Costas slope discriminator.
    """
    v = prompts**2
    nfft = 8192
    spec = np.abs(np.fft.fft(v * np.hanning(len(v)), nfft))
    freqs = np.fft.fftfreq(nfft, d=CA_SEQ_LEN_E1 / CODE_FREQ_E1)
    return float(freqs[int(np.argmax(spec))]) / 2.0


def track(
    x: np.ndarray,
    acq: Acquisition,
    block: int = 104000,
    meas_every: int = 6,
    max_periods: int | None = None,
    model=None,
) -> TrackResult:
    """Track one satellite through the whole stream.

    meas_every: blocks between multi-lag code-phase measurements (the
    carrier-aided NCO drifts < 1e-3 chips between them; the signal also
    carries the reference's +f_code*(dt-0.1) ~ +0.024-chip jump at every
    0.1 s epoch seam -- the reference advances its epoch clock by
    dt = 0.10000002314 while emitting exactly 0.1 s of samples
    (galileo-sdr.cpp:347) -- which the code loop follows as a common-mode
    ramp, absorbed by the receiver clock term in the PVT solve).
    """
    # model-matched replicas (see acquire); `sub` scales chip->table index
    if model is None:
        sub = 2.0
        bocB = boc_chips("E1B")[acq.prn - 1].astype(np.float64)
        bocC = boc_chips("E1C")[acq.prn - 1].astype(np.float64)
    else:
        sub = float(model.code_subdiv)
        bocB = model.data_codes[acq.prn - 1].astype(np.float64)
        bocC = model.pilot_codes[acq.prn - 1].astype(np.float64)
    subL = int(sub) * CA_SEQ_LEN_E1
    fs = SAMP_RATE
    nsamp = len(x)
    n_blocks = nsamp // block

    fd = acq.doppler
    f_code = CODE_FREQ_E1 + fd * CARR_TO_CODE_E1
    cp_u = acq.code_phase  # unwrapped chips at sample 0 (period 0 origin)
    phase = 0.0  # carrier NCO phase [cycles] at block start

    kmax = max_periods or (nsamp // N_PER + 4)
    d_acc = np.zeros(kmax, np.complex128)
    p_acc = np.zeros(kmax, np.complex128)
    n_cnt = np.zeros(kmax, np.int64)

    n_start, cp_start, fc_hist, err_hist = [], [], [], []
    n_rel = np.arange(block)
    wide = True  # first block: wide pull-in lag grid
    fine_done = False  # first block: FFT fine-frequency, then restart

    b = 0
    while b < n_blocks:
        n0 = b * block
        seg = x[n0 : n0 + block]
        fd_wipe = fd  # fd used for this block's wipe (phase continuity)
        ph = phase + fd_wipe / fs * n_rel
        base = seg * np.exp(-2j * np.pi * ph)
        cp = cp_u + (f_code / fs) * n_rel  # float64 unwrapped chips

        kk = np.floor(cp / CA_SEQ_LEN_E1).astype(np.int64)
        cuts = np.flatnonzero(np.diff(kk)) + 1
        starts = np.concatenate([[0], cuts])
        seg_k = kk[starts]

        # --- code-phase measurement (multi-lag apex) -------------------
        if wide or (b % meas_every == 0):
            was_wide = wide
            taus = (
                np.arange(-0.52, 0.521, 0.04)
                if wide
                else np.arange(-0.12, 0.121, 0.04)
            )
            r = np.empty(len(taus))
            for ti, tau in enumerate(taus):
                hc = np.floor(sub * (cp + tau)).astype(np.int64) % subL
                y = base * bocB[hc]
                r[ti] = np.abs(np.add.reduceat(y, starts)).sum()
            if wide:
                # recentre on the max, then apex-fit a narrow grid
                t0 = taus[int(np.argmax(r))]
                taus = t0 + np.arange(-0.12, 0.121, 0.04)
                r = np.empty(len(taus))
                for ti, tau in enumerate(taus):
                    hc = np.floor(sub * (cp + tau)).astype(np.int64) % subL
                    y = base * bocB[hc]
                    r[ti] = np.abs(np.add.reduceat(y, starts)).sum()
                wide = False
            err = _apex(taus, r)
            if not was_wide and abs(err - taus[len(taus) // 2]) >= 0.10:
                # correction saturated the narrow lag grid: lost the
                # linear region -- redo this block with the wide sweep
                wide = True
                continue
            err_hist.append((b, err))
            # replica shifted by +err matches best => true phase = cp + err
            cp = cp + err
            cp_u += err
            kk = np.floor(cp / CA_SEQ_LEN_E1).astype(np.int64)
            cuts = np.flatnonzero(np.diff(kk)) + 1
            starts = np.concatenate([[0], cuts])
            seg_k = kk[starts]

        n_start.append(n0)
        cp_start.append(cp_u)
        fc_hist.append(f_code)

        # --- prompts ----------------------------------------------------
        hc = np.floor(sub * cp).astype(np.int64) % subL
        yb = base * bocB[hc]
        yc = base * bocC[hc]
        db = np.add.reduceat(yb, starts)
        pb = np.add.reduceat(yc, starts)

        # --- one-shot fine frequency, then reprocess block 0 ------------
        if not fine_done:
            fine_done = True
            if len(db) > 4:
                fd += _fine_freq(db[1:-1])
                f_code = CODE_FREQ_E1 + fd * CARR_TO_CODE_E1
                n_start.clear(), cp_start.clear(), fc_hist.clear()
                continue  # cp_u unchanged (pre-propagation), phase = 0
        lens = np.diff(np.concatenate([starts, [block]]))
        valid = seg_k < kmax
        np.add.at(d_acc, seg_k[valid], db[valid])
        np.add.at(p_acc, seg_k[valid], pb[valid])
        np.add.at(n_cnt, seg_k[valid], lens[valid])

        # --- carrier update (Costas phase-slope over squared prompts) --
        if len(db) >= 4:
            v = db[1:-1] ** 2  # full periods only
            w = v[1:] * np.conj(v[:-1])
            sw = w.sum()
            if np.abs(sw) > 0:
                dfreq = np.angle(sw) / (2.0 * TWO_PI * (CA_SEQ_LEN_E1 / CODE_FREQ_E1))
                fd += 0.7 * dfreq

        phase = (phase + fd_wipe / fs * block) % 1.0
        cp_u = cp_u + f_code / fs * block
        f_code = CODE_FREQ_E1 + fd * CARR_TO_CODE_E1
        b += 1

    return TrackResult(
        prn=acq.prn,
        doppler=fd,
        n_start=np.asarray(n_start, np.float64),
        cp_start=np.asarray(cp_start),
        f_code=np.asarray(fc_hist),
        d_prompt=d_acc,
        p_prompt=p_acc,
        n_count=n_cnt,
        err_hist=err_hist,
    )
