"""Receiver-side ephemeris recovery and PVT solve from the emitted stream.

Completes the acceptance chain the reference delegates to GNSS-SDR +
RTKLIB (reference gnss-sdr_Galileo_E1_ishort.conf:77-100, README.md:72-78):
acquire -> track -> frame-sync -> Viterbi/CRC decode -> ephemeris
reconstruction -> pseudoranges -> least-squares position fix, using only
the int16 I/Q samples.

Stages here (tracking comes from rx_track.py, page decode from rx.py):

* secondary-code / frame alignment: the data symbol is recovered from
  the carrier-free product d*s = -sign(Re(P_d * conj(P_p))) (the mix is
  chip_b*d - chip_c*s, galileo-sdr.cpp:520), with the E1C secondary
  phase `off` found jointly with the sync pattern + CRC;
* word field parsing: exact inverse of inav.generate_page_pair's
  BitWriter layout for word types 0-6 (reference inav-msg.cpp:195-384);
* timing anchor: the transmitted TOW field is int(grx.sec) at the epoch
  the page rolled over, while the page's first symbol leaves the
  satellite at an *odd* GST second (the (ibit+250)%500 half-page offset,
  gal-sig.cpp:334 / observables.code_phase_state) -- so page-start
  transmit time = 2*(TOW//2) + 1; a consensus vote over all TOW-bearing
  pages rejects the first (partial) page's ambiguous stamp;
* pseudoranges: t_tx at a common receive sample from the tracker's
  unwrapped code-phase model (chips advance at exactly 1.023e6 per
  satellite-time second);
* solve: Newton least squares for (x, y, z, t_rx) against the same
  observation model the transmitter used (observables.compute_range:
  satpos + light-time + Earth rotation + clock + NeQuick iono), with the
  iono coefficients taken from the decoded word 5 -- exactly what a real
  Galileo receiver does per the ICD.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .codes import secondary_code, sync_pattern
from .constants import (
    CA_SEQ_LEN_E1,
    CODE_FREQ_E1,
    GNSS_PI,
    MAX_SAT,
    OMEGA_EARTH,
    SAMP_RATE,
    SPEED_OF_LIGHT,
    WGS_SQRT_GM,
)
from .gnss_time import GalTime
from .observables import compute_range
from .rinex import Ephemeris, EphArrays, IonoUtc
from .rx import DecodedPage, decode_page_pair
from .rx_track import Acquisition, TrackResult, acquire, track

N_SEC = 25  # E1C secondary code length [symbols]


# --- word-content bit reader -------------------------------------------


class BitReader:
    """MSB-first field reader over the 226-bit content stream
    (inverse of inav.BitWriter)."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, dtype=np.uint8)
        self.off = 0

    def u(self, n: int) -> int:
        v = 0
        for b in self.bits[self.off : self.off + n]:
            v = (v << 1) | int(b)
        self.off += n
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v


def page_content(dp: DecodedPage) -> np.ndarray:
    """Undo the odd-page header insertion at bit 114
    (inav.generate_page_pair / inav-msg.cpp:393-395): the original
    writer stream is even[:114] ++ odd[2:114]."""
    return np.concatenate([dp.even[:114], dp.odd[2:114]])


def parse_word(content: np.ndarray) -> dict:
    """Field dict for one decoded word (inverse of the packing in
    inav.generate_page_pair; scale factors per the ICD)."""
    r = BitReader(content)
    wt = r.u(8)
    out = {"word_type": wt}
    if wt == 0:
        r.u(2)
        r.u(88)
        out["wn"] = r.u(12)
        out["tow"] = r.u(20)
    elif wt == 1:
        out["iode"] = r.u(10)
        out["toe_sec"] = r.u(14) * 60.0
        out["m0"] = r.s(32) * 2.0**-31 * GNSS_PI
        out["ecc"] = r.u(32) * 2.0**-33
        out["sqrta"] = r.u(32) * 2.0**-19
    elif wt == 2:
        out["iode"] = r.u(10)
        out["omg0"] = r.s(32) * 2.0**-31 * GNSS_PI
        out["inc0"] = r.s(32) * 2.0**-31 * GNSS_PI
        out["aop"] = r.s(32) * 2.0**-31 * GNSS_PI
        out["idot"] = r.s(14) * 2.0**-43 * GNSS_PI
    elif wt == 3:
        out["iode"] = r.u(10)
        out["omgdot"] = r.s(24) * 2.0**-43 * GNSS_PI
        out["deltan"] = r.s(16) * 2.0**-43 * GNSS_PI
        out["cuc"] = r.s(16) * 2.0**-29
        out["cus"] = r.s(16) * 2.0**-29
        out["crc"] = r.s(16) * 2.0**-5
        out["crs"] = r.s(16) * 2.0**-5
        out["sisa"] = r.u(8)
    elif wt == 4:
        out["iode"] = r.u(10)
        out["svid"] = r.u(6)
        out["cic"] = r.s(16) * 2.0**-29
        out["cis"] = r.s(16) * 2.0**-29
        out["toc_sec"] = r.u(14) * 60.0
        out["af0"] = r.s(31) * 2.0**-34
        out["af1"] = r.s(21) * 2.0**-46
        out["af2"] = r.s(6) * 2.0**-59
    elif wt == 5:
        out["ai0"] = r.u(11) * 2.0**-2
        out["ai1"] = r.s(11) * 2.0**-8
        out["ai2"] = r.s(14) * 2.0**-15
        out["region"] = r.u(5)
        out["bgde5a"] = r.s(10) * 2.0**-32
        out["bgde5b"] = r.s(10) * 2.0**-32
        out["e5b_hs"] = r.u(2)
        out["e1b_hs"] = r.u(2)
        out["e5b_dvs"] = r.u(1)
        out["e1b_dvs"] = r.u(1)
        out["wn"] = r.u(12)
        out["tow"] = r.u(20)
    elif wt == 16:
        # reduced CED (inverse of inav._put_word16 / WORD16_LAYOUT)
        from .inav import WORD16_LAYOUT

        for name, nbits, scale in WORD16_LAYOUT:
            out[name] = r.s(nbits) * 2.0**scale
    elif wt in (17, 18, 19, 20):
        # FEC2 Reed-Solomon CED parity, 15 octets (fec2.py)
        out["parity"] = np.array([r.u(8) for _ in range(15)], np.uint8)
    elif wt == 6:
        out["A0"] = r.s(32) * 2.0**-30
        out["A1"] = r.s(24) * 2.0**-50
        out["dtls"] = r.s(8)
        out["tot"] = r.u(8) * 3600
        out["wnt"] = r.u(8)
        out["wnlsf"] = r.u(8)
        out["dn"] = r.u(3)
        out["dtlsf"] = r.s(8)
        out["tow"] = r.u(20)
    return out


def assemble_ephemeris(words: dict[int, dict], week: int, prn: int) -> Ephemeris:
    """Ephemeris record from decoded word types 1-5 (the inverse of the
    RINEX->word packing; derived terms as rinex.cpp:226-230)."""
    w1, w2, w3, w4 = words[1], words[2], words[3], words[4]
    bgde5b = words[5]["bgde5b"] if 5 in words else 0.0
    sqrta = w1["sqrta"]
    ecc = w1["ecc"]
    rec = Ephemeris(
        svid=prn,
        toc=GalTime(week, w4["toc_sec"]),
        toe=GalTime(week, w1["toe_sec"]),
        af0=w4["af0"],
        af1=w4["af1"],
        af2=w4["af2"],
        iode=w1["iode"],
        crs=w3["crs"],
        deltan=w3["deltan"],
        m0=w1["m0"],
        cuc=w3["cuc"],
        ecc=ecc,
        cus=w3["cus"],
        sqrta=sqrta,
        cic=w4["cic"],
        omg0=w2["omg0"],
        cis=w4["cis"],
        inc0=w2["inc0"],
        crc=w3["crc"],
        aop=w2["aop"],
        omgdot=w3["omgdot"],
        idot=w2["idot"],
        flag=517,
        week=week,
        sisa=0.0,
        svhlth=0,
        bgde5a=words[5]["bgde5a"] if 5 in words else 0.0,
        bgde5b=bgde5b,
        ura=0,
    )
    rec.A = sqrta * sqrta
    rec.n = WGS_SQRT_GM / (sqrta * rec.A) + rec.deltan
    rec.sq1e2 = float(np.sqrt(1.0 - ecc * ecc))
    rec.omgkdot = rec.omgdot - OMEGA_EARTH
    return rec


def reconstruct_ced_fec2(
    contents: dict[int, np.ndarray], week: int
) -> Ephemeris:
    """Ephemeris from ANY >= 58-octet-covering subset of words
    {1, 2, 3, 4, 17, 18, 19, 20} via RS(118, 58) erasure decoding —
    the receiver-side payoff of the FEC2 words: e.g. two lost CED words
    are reconstructed from two FEC2 parity words (fec2.py).

    `contents` maps word_type -> the word's 130-bit content bitstream
    (page_content of a CRC-clean DecodedPage)."""
    from .fec2 import (
        codeword_from_words,
        info_octets_to_ced,
        rs_decode_erasures,
    )

    code, erased = codeword_from_words(contents)
    rec = rs_decode_erasures(code, erased)
    svid, iodnav, f = info_octets_to_ced(rec[:58])

    def s(name: str, nbits: int, scale: float) -> float:
        v = f[name]
        if v >> (nbits - 1):
            v -= 1 << nbits
        return v * scale

    words = {
        1: {
            "iode": iodnav,
            "toe_sec": f["toe"] * 60.0,
            "m0": s("m0", 32, 2.0**-31) * GNSS_PI,
            "ecc": f["e"] * 2.0**-33,
            "sqrta": f["sqrta"] * 2.0**-19,
        },
        2: {
            "omg0": s("omg0", 32, 2.0**-31) * GNSS_PI,
            "inc0": s("inc0", 32, 2.0**-31) * GNSS_PI,
            "aop": s("aop", 32, 2.0**-31) * GNSS_PI,
            "idot": s("idot", 14, 2.0**-43) * GNSS_PI,
        },
        3: {
            "omgdot": s("omgdot", 24, 2.0**-43) * GNSS_PI,
            "deltan": s("deltan", 16, 2.0**-43) * GNSS_PI,
            "cuc": s("cuc", 16, 2.0**-29),
            "cus": s("cus", 16, 2.0**-29),
            "crc": s("crc", 16, 2.0**-5),
            "crs": s("crs", 16, 2.0**-5),
        },
        4: {
            "cic": s("cic", 16, 2.0**-29),
            "cis": s("cis", 16, 2.0**-29),
            "toc_sec": f["toc"] * 60.0,
            "af0": s("af0", 31, 2.0**-34),
            "af1": s("af1", 21, 2.0**-46),
            "af2": s("af2", 6, 2.0**-59),
        },
    }
    return assemble_ephemeris(words, week, svid)


def assemble_iono(w5: dict | None, w6: dict | None = None) -> IonoUtc:
    iono = IonoUtc()
    if w5 is not None:
        iono.ai0, iono.ai1, iono.ai2 = w5["ai0"], w5["ai1"], w5["ai2"]
        iono.vflg = True
    if w6 is not None:
        iono.A0, iono.A1 = w6["A0"], w6["A1"]
        iono.dtls, iono.dtlsf = w6["dtls"], w6["dtlsf"]
    return iono


# --- frame sync + decode over one tracked channel ----------------------


@dataclass
class ChannelDecode:
    prn: int
    sec_offset: int  # E1C secondary phase: s_k = secondary[(k + off) % 25]
    pages: list[tuple[int, DecodedPage]]  # (page-start period index, page)
    words: dict[int, dict]
    t_anchor: float | None  # transmit time [s of week] at period 0 start


def _symbol_stream(tr: TrackResult) -> tuple[np.ndarray, np.ndarray]:
    """(k_idx, ds) for complete periods: ds_k = d_k * s_k in {-1, +1}."""
    full = tr.n_count >= int(0.8 * (SAMP_RATE * CA_SEQ_LEN_E1 / CODE_FREQ_E1))
    k = np.flatnonzero(full)
    r = np.real(tr.d_prompt[k] * np.conj(tr.p_prompt[k]))
    return k, np.where(r < 0, 1, -1)  # ds = -sign(Re r)


def decode_channel(tr: TrackResult) -> ChannelDecode | None:
    """Frame-sync + decode all CRC-valid pages of one tracked channel."""
    k_idx, ds = _symbol_stream(tr)
    if len(k_idx) < 520:
        return None
    # need a contiguous run of periods
    run0 = 0
    contig = np.flatnonzero(np.diff(k_idx) != 1)
    k0 = int(k_idx[run0])
    n = int(contig[0]) + 1 if len(contig) else len(k_idx)
    ds = ds[run0 : run0 + n]
    sec = secondary_code().astype(np.int64)
    sync = np.where(sync_pattern() > 0, -1, 1)  # on-air symbol amplitudes

    for off in range(N_SEC):
        s = sec[(k0 + np.arange(n) + off) % N_SEC]
        d = ds * s
        # page starts only where the secondary phase is 0
        cand = [
            i
            for i in range(0, n - 510)
            if (k0 + i + off) % N_SEC == 0
            and np.array_equal(d[i : i + 10], sync)
            and np.array_equal(d[i + 250 : i + 260], sync)
        ]
        if not cand:
            continue
        sym = ((1 - d) // 2).astype(np.uint8)  # amplitude -1 -> bit 1
        # sync repeats every 250 symbols (even AND odd half pages); the
        # page *pair* starts at the candidate with the right parity --
        # try both and keep the one whose even/odd headers + CRC verify.
        pages = []
        for i0 in (cand[0], cand[0] + 250):
            pages = []
            for i in range(i0, n - 500 + 1, 500):
                try:
                    dp = decode_page_pair(sym[i : i + 500])
                except ValueError:
                    continue
                if dp.crc_ok and dp.even[0] == 0 and dp.odd[0] == 1:
                    pages.append((k0 + i, dp))
            if len(pages) >= 2:
                break
        if len(pages) >= 2:
            words: dict[int, dict] = {}
            anchors = []
            for kp, dp in pages:
                w = parse_word(page_content(dp))
                words.setdefault(w["word_type"], w)
                if "tow" in w:
                    # page-start transmit time = odd second 2*(TOW//2)+1
                    t_page = 2.0 * (w["tow"] // 2) + 1.0
                    anchors.append(t_page - 0.004 * kp)
            t_anchor = None
            if anchors:
                vals, counts = np.unique(np.round(anchors, 6), return_counts=True)
                t_anchor = float(vals[np.argmax(counts)])
            return ChannelDecode(
                prn=tr.prn, sec_offset=off, pages=pages, words=words,
                t_anchor=t_anchor,
            )
    return None


# --- PVT solve ----------------------------------------------------------


@dataclass
class PvtSolution:
    xyz: np.ndarray  # ECEF receiver position [m]
    t_rx: float  # receive time [s of week]
    residuals: np.ndarray  # post-fit [m]
    n_sats: int
    prns: list[int]


def solve_pvt(
    eph_list: list[Ephemeris],
    t_tx: np.ndarray,
    iono: IonoUtc,
    week: int,
    x0: np.ndarray | None = None,
    iters: int = 8,
) -> PvtSolution:
    """Newton least squares for (x, y, z, t_rx).

    Model: c*(t_rx - t_tx_i) = pr_i(x, t_rx), with pr from
    observables.compute_range (satpos + light time + Earth rotation +
    clock incl. BGD + NeQuick iono) -- the exact forward model of the
    transmitter, which is also the ICD receiver model.
    """
    t_tx = np.asarray(t_tx, np.float64)
    S = len(eph_list)
    eph_arr = EphArrays.from_records(eph_list)
    x = np.zeros(3) if x0 is None else np.asarray(x0, np.float64).copy()
    t_rx = float(np.max(t_tx) + 0.077)

    def model(xv, trx):
        rho = compute_range(eph_arr, iono, week, np.full(S, trx), xv)
        return rho.range

    # residual r_i(x, t_rx) = c*(t_rx - t_tx_i) - model_i(x, t_rx) -> 0
    for _ in range(iters):
        f0 = model(x, t_rx)
        res = SPEED_OF_LIGHT * (t_rx - t_tx) - f0
        J = np.zeros((S, 4))
        d = 1.0  # meters
        for j in range(3):
            dx = np.zeros(3)
            dx[j] = d
            J[:, j] = -(model(x + dx, t_rx) - f0) / d
        dt = 1e-6  # seconds
        J[:, 3] = SPEED_OF_LIGHT - (model(x, t_rx + dt) - f0) / dt
        upd, *_ = np.linalg.lstsq(J, -res, rcond=None)
        x += upd[:3]
        t_rx += upd[3]
        if np.max(np.abs(upd[:3])) < 1e-4:
            break
    res = SPEED_OF_LIGHT * (t_rx - t_tx) - model(x, t_rx)
    return PvtSolution(
        xyz=x, t_rx=t_rx, residuals=res, n_sats=S,
        prns=[e.svid for e in eph_list],
    )


# --- end-to-end orchestration -------------------------------------------


@dataclass
class ReceiverFix:
    solution: PvtSolution
    channels: list[ChannelDecode]
    tracks: dict[int, TrackResult]
    week: int


def receiver_fix(
    x: np.ndarray,
    prn_candidates: list[int] | None = None,
    meas_sample: float | None = None,
    acq_threshold: float = 8.0,
    min_sats: int = 4,
    n_noncoh: int = 1,
    model=None,
) -> ReceiverFix | None:
    """Full receiver chain on a complex baseband stream: returns the PVT
    fix, or None when fewer than min_sats decode.  For noisy streams
    pass n_noncoh > 1 (non-coherent acquisition accumulation; see
    rx_track.acquire).  `model` selects a matched correlator waveform
    (e.g. models.cboc.E1_CBOC); default is the sine-BOC(1,1) replica the
    reference's GNSS-SDR eval uses (conf cboc=false)."""
    prns = prn_candidates or list(range(1, MAX_SAT + 1))
    acqs: list[Acquisition] = []
    for prn in prns:
        a = acquire(x, prn, n_noncoh=n_noncoh, model=model)
        if a.metric > acq_threshold:
            acqs.append(a)
    tracks: dict[int, TrackResult] = {}
    decodes: list[ChannelDecode] = []
    for a in acqs:
        tr = track(x, a, model=model)
        dec = decode_channel(tr)
        if dec is not None and all(
            w in dec.words for w in (1, 2, 3, 4, 5)
        ) and dec.t_anchor is not None:
            tracks[a.prn] = tr
            decodes.append(dec)
    if len(decodes) < min_sats:
        return None

    week = decodes[0].words[5]["wn"] + 1024
    iono = assemble_iono(
        decodes[0].words.get(5), decodes[0].words.get(6)
    )
    n_meas = meas_sample if meas_sample is not None else 0.5 * len(x)
    eph_list, t_tx = [], []
    for dec in decodes:
        tr = tracks[dec.prn]
        eph_list.append(assemble_ephemeris(dec.words, week, dec.prn))
        chips = tr.chips_at(n_meas)
        t_tx.append(dec.t_anchor + chips / CODE_FREQ_E1)
    sol = solve_pvt(eph_list, np.asarray(t_tx), iono, week)
    return ReceiverFix(solution=sol, channels=decodes, tracks=tracks, week=week)
