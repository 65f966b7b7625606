"""Receiver-side I/NAV decoding: deinterleave, Viterbi, CRC, page parse.

The reference delegates this stage to GNSS-SDR's telemetry decoder
(SURVEY §4: the receiver-in-the-loop is the real test; reference
gnss-sdr_Galileo_E1_ishort.conf:67-69).  Providing the decoder in-repo
lets the acceptance chain — acquire, track, decode, CRC — run in CI with
no external receiver, and gives users a message-level probe for any
emitted stream.

Inverse of the transmit chain in inav.py (reference inav-msg.cpp):
250-symbol half page = 10-symbol sync + 8x30 block-interleaved K=7
rate-1/2 convolutional code with inverted G2 (ICD fig. 13).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .codes import sync_pattern
from .inav import G1_TAPS, G2_TAPS, crc24q

N_STATES = 64  # K=7 -> 2^(K-1)


def deinterleave(symbols: np.ndarray) -> np.ndarray:
    """Inverse of inav.interleave: 240 symbols row-read -> column-write
    (reference inav-msg.cpp:11-19)."""
    return np.asarray(symbols, dtype=np.uint8).reshape(8, 30).T.reshape(-1)


def _output_tables() -> tuple[np.ndarray, np.ndarray]:
    """g1/g2 output bit for (state, input): state = last 6 inputs,
    state bit 0 = most recent."""
    states = np.arange(N_STATES)
    hist = ((states[:, None] >> np.arange(6)) & 1).astype(np.uint8)  # (64, 6)
    g1 = np.empty((N_STATES, 2), np.uint8)
    g2 = np.empty((N_STATES, 2), np.uint8)
    for b in (0, 1):
        win = np.concatenate(
            [np.full((N_STATES, 1), b, np.uint8), hist], axis=1
        )  # taps j multiply u[t-j]
        g1[:, b] = (win @ G1_TAPS) & 1
        g2[:, b] = (win @ G2_TAPS) & 1
    return g1, g2


_G1_OUT, _G2_OUT = _output_tables()


def viterbi_decode(symbols: np.ndarray, n_bits: int) -> np.ndarray:
    """Hard-decision Viterbi for the K=7 rate-1/2 code with inverted G2.

    symbols: (2*n_bits,) {0,1} as transmitted (G2 branch already
    inverted on air, inav.conv_encode); returns (n_bits,) decoded bits.
    Assumes zero initial state and zero tail (the 120-bit half pages end
    in six zero bits).

    State encoding: bit j of the state is input u[t-j] (bit 0 newest),
    so the transition on input b is ns = ((s << 1) | b) & 63 and the
    newest input is recoverable as ns & 1 during traceback.
    """
    sym = np.asarray(symbols, dtype=np.uint8).reshape(-1, 2)
    n = sym.shape[0]
    assert n == n_bits, (n, n_bits)
    INF = 1 << 30
    metric = np.full(N_STATES, INF, np.int64)
    metric[0] = 0
    prev_state = np.zeros((n, N_STATES), np.int32)

    ns = np.arange(N_STATES)
    b = (ns & 1).astype(np.uint8)  # input implied by the next state
    s0 = ns >> 1  # the two predecessors of ns
    s1 = s0 | 32
    for t in range(n):
        r1, r2 = int(sym[t, 0]), int(sym[t, 1])
        cost0 = (
            (_G1_OUT[s0, b] ^ r1).astype(np.int64)
            + ((1 - _G2_OUT[s0, b]) ^ r2).astype(np.int64)
        )
        cost1 = (
            (_G1_OUT[s1, b] ^ r1).astype(np.int64)
            + ((1 - _G2_OUT[s1, b]) ^ r2).astype(np.int64)
        )
        cand0 = metric[s0] + cost0
        cand1 = metric[s1] + cost1
        take1 = cand1 < cand0
        prev_state[t] = np.where(take1, s1, s0)
        metric = np.where(take1, cand1, cand0)

    # traceback from the zero state (tail-terminated)
    bits = np.zeros(n, np.uint8)
    s = 0
    for t in range(n - 1, -1, -1):
        bits[t] = s & 1
        s = int(prev_state[t, s])
    return bits


@dataclass
class DecodedPage:
    even: np.ndarray  # (120,) bits
    odd: np.ndarray  # (120,) bits
    page: np.ndarray  # (228,) concatenated content bits
    word_type: int
    crc_ok: bool
    ssp: int


def decode_half_page(symbols_250: np.ndarray) -> np.ndarray:
    """250 on-air symbols -> 120 decoded bits (sync verified)."""
    s = np.asarray(symbols_250, dtype=np.uint8)
    if not np.array_equal(s[:10], sync_pattern()):
        raise ValueError("sync pattern mismatch")
    return viterbi_decode(deinterleave(s[10:]), 120)


def decode_page_pair(symbols_500: np.ndarray) -> DecodedPage:
    """One 2 s page pair of on-air symbols -> content bits + CRC verdict
    (inverse of inav.generate_inav_page)."""
    even = decode_half_page(symbols_500[:250])
    odd = decode_half_page(symbols_500[250:])
    page = np.concatenate([even[:114], odd[:114]])
    crc_bits = page[196:220]
    claimed = 0
    for b in crc_bits:
        claimed = (claimed << 1) | int(b)
    ssp = 0
    for b in page[220:228]:
        ssp = (ssp << 1) | int(b)
    wt = 0
    for b in page[0:8]:
        wt = (wt << 1) | int(b)
    return DecodedPage(
        even=even,
        odd=odd,
        page=page,
        word_type=wt,
        crc_ok=crc24q(page[:196]) == claimed,
        ssp=ssp,
    )


# --- almanac decode (word types 7-10) ----------------------------------


def word_data_bits(page: np.ndarray) -> np.ndarray:
    """(228,) content bits -> the 128-bit word data field.

    The word spans content bits [2:114] and [116:132]: the odd-page
    header bits (1, 0) are INSERTED at content bit 114 by the encoder
    (inav-msg.cpp:128-139) and are not word content.  (Getting this
    wrong corrupts every field that crosses the even/odd seam — it was
    reverse-confirmed against the live-sky tv/ captures.)"""
    return np.concatenate([page[2:114], page[116:132]])


def _bits_u(b: np.ndarray) -> int:
    v = 0
    for x in b:
        v = (v << 1) | int(x)
    return v


def _bits_s(b: np.ndarray) -> int:
    v = _bits_u(b)
    return v - (1 << len(b)) if b[0] else v


def decode_almanac_word(page: np.ndarray) -> dict:
    """Parse one word-type-7..10 content page into almanac fields.

    Field layouts per the OS SIS ICD, reverse-validated against the tv/
    live-sky captures (every CRC-clean captured word's elements match
    the same satellite's RINEX ephemeris to quantization).  Scales:
    Dsqrt(a) 2^-9 vs sqrt(29 600 km), e 2^-16, omega/Omega0/M0 2^-15
    semicircles, delta-i 2^-14 vs 56 deg, Omega-dot 2^-33, af0 2^-19,
    af1 2^-38, A0G 2^-35, A1G 2^-51."""
    w = word_data_bits(page)
    wt = _bits_u(w[:6])
    i = [6]

    def u(n):
        b = w[i[0]:i[0] + n]
        i[0] += n
        return _bits_u(b)

    def s(n):
        b = w[i[0]:i[0] + n]
        i[0] += n
        return _bits_s(b)

    def orbit1():
        return dict(dsqrta=s(13) * 2.0**-9, ecc=u(11) * 2.0**-16,
                    aop=s(16) * 2.0**-15, di=s(11) * 2.0**-14)

    def orbit2():
        return dict(om0=s(16) * 2.0**-15, omgdot=s(11) * 2.0**-33)

    def clock():
        return dict(af0=s(16) * 2.0**-19, af1=s(13) * 2.0**-38,
                    e5bhs=u(2), e1bhs=u(2))

    out: dict = {"word_type": wt}
    if wt == 7:
        out.update(ioda=u(4), wna=u(2), t0a=u(10), svid1=u(6))
        out["sv1"] = {**orbit1(), **orbit2(), "m0": s(16) * 2.0**-15}
    elif wt == 8:
        out.update(ioda=u(4))
        out["sv1_clock"] = clock()
        out.update(svid2=u(6))
        out["sv2"] = {**orbit1(), **orbit2()}
    elif wt == 9:
        out.update(ioda=u(4), wna=u(2), t0a=u(10))
        out["sv2_tail"] = {"m0": s(16) * 2.0**-15, **clock()}
        out.update(svid3=u(6))
        out["sv3"] = orbit1()
    elif wt == 10:
        out.update(ioda=u(4))
        out["sv3_tail"] = {**orbit2(), "m0": s(16) * 2.0**-15, **clock()}
        out.update(a0g=s(16) * 2.0**-35, a1g=s(12) * 2.0**-51,
                   t0g=u(8), wn0g=u(6))
    else:
        raise ValueError(f"not an almanac word: type {wt}")
    return out


# --- reduced CED decode (word type 16; beyond the reference) -----------


def decode_word16(page: np.ndarray) -> dict:
    """Parse a word-type-16 content page into reduced CED fields
    (inverse of inav._put_word16; layout inav.WORD16_LAYOUT)."""
    from .inav import WORD16_LAYOUT

    w = word_data_bits(page)
    wt = _bits_u(w[:6])
    if wt != 16:
        raise ValueError(f"not a reduced-CED word: type {wt}")
    out: dict = {"word_type": wt}
    i = 6
    for name, nbits, scale in WORD16_LAYOUT:
        out[name] = _bits_s(w[i:i + nbits]) * 2.0 ** scale
        i += nbits
    return out


def reduced_ced_record(fields: dict, t0r: float, week: int):
    """Reduced CED fields -> an ephemeris-like record usable by
    geodesy.satpos (rates/harmonics zero, toe = toc = t0r), per the
    reduced-CED reconstruction: A = A_red_nom + DA, (e, omega) from the
    eccentricity vector, i0 = 56 deg + Di0, M0 = lambda0 - omega."""
    from types import SimpleNamespace

    from .constants import OMEGA_EARTH, WGS_SQRT_GM
    from .inav import A_RED_NOM, I_RED_NOM

    A = A_RED_NOM + fields["dA"]
    ecc = float(np.hypot(fields["ex"], fields["ey"]))
    aop = float(np.arctan2(fields["ey"], fields["ex"]))
    m0 = fields["lam0"] * np.pi - aop
    return SimpleNamespace(
        m0=m0,
        ecc=ecc,
        sqrta=np.sqrt(A),
        A=A,
        n=WGS_SQRT_GM / (np.sqrt(A) * A),
        sq1e2=np.sqrt(1.0 - ecc * ecc),
        aop=aop,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        inc0=(I_RED_NOM + fields["di"]) * np.pi,
        idot=0.0,
        omg0=fields["om0"] * np.pi,
        omgkdot=-OMEGA_EARTH,
        toe_sec=t0r,
        toc_sec=t0r,
        af0=fields["af0"],
        af1=fields["af1"],
        af2=0.0,
        bgde5b=0.0,
    )
