"""FEC2 outer code: Reed-Solomon (118, 58) over GF(2^8) for I/NAV CED.

The Galileo OS SIS ICD v2.0 I/NAV improvements add an outer systematic
Reed-Solomon code over the clock-and-ephemeris data (CED): 58
information octets derived from word types 1-4 are extended with 60
parity octets transmitted in word types 17-20 (15 octets each), so a
receiver can reconstruct the full CED from ANY 58 of the 118 octets —
e.g. from two CED words plus two FEC2 words, halving the time to first
fix under erasures.  The reference emits dummy word 63 in the 17/19
schedule slots (reference src/inav-msg.cpp:377-384); this module is a
beyond-parity feature in the same spirit as the real almanac words 7-10
and reduced CED word 16.

Code construction (documented precisely so it is falsifiable):

* Field: GF(2^8) with primitive polynomial
  p(x) = x^8 + x^4 + x^3 + x^2 + 1 (0x11D), alpha = 0x02.
* Code: shortened systematic RS(118, 58) from RS(255, 195),
  generator g(x) = prod_{i=0..59} (x - alpha^i).
* Codeword octet 0..57 = information, 58..117 = parity; the polynomial
  convention is c(x) = sum_j c[j] * x^(117-j) (codeword index 0 is the
  highest-degree coefficient), with the shortened positions (the
  leading 137 virtual octets of the mother code) identically zero.
* Information octets: octet 0 = SVID(6 MSBs) | IODnav(2 MSBs),
  octet 1 = IODnav(8 LSBs), octets 2..57 = the 448-bit big-endian
  concatenation of the CED/clock payload fields in word order
  (toe, M0, e, sqrtA | Omega0, i0, omega, idot | OmegaDot, deltan,
  Cuc, Cus, Crc, Crs, SISA | Cic, Cis, toc, af0, af1, af2, 12 pad
  bits) — exactly the quantized integers the word-1..4 builders emit
  (inav.generate_page_pair), so the RS information is bit-consistent
  with the transmitted CED words.

Environment caveat (same class as word 16, docs/ab_validation.md): the
ICD v2.0 FEC2 annex is not retrievable here (zero egress) and every tv/
capture predates the I/NAV-improvements rollout, so the exact on-air
octet order cannot be A/B-anchored.  Correctness is pinned by
construction + round trip instead: tests/test_inav_fec2.py erases up to
60 arbitrary codeword positions (including "all four CED words lost")
and requires exact CED recovery through the erasure decoder, and the
full-chain test decodes words 17-20 out of modulated pages and
reconstructs the ephemeris.
"""

from __future__ import annotations

import numpy as np

_PRIM = 0x11D
N_MOTHER = 255
K_INFO = 58
N_PARITY = 60
N_CODE = K_INFO + N_PARITY  # 118

# --- GF(2^8) tables ----------------------------------------------------
_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:510] = _EXP[:255]


def _gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gdiv(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] - _LOG[b]) % 255])


def _poly_mul(p: list[int], q: list[int]) -> list[int]:
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] ^= _gmul(a, b)
    return out


def _generator_poly() -> np.ndarray:
    g = [1]
    for i in range(N_PARITY):
        g = _poly_mul(g, [1, int(_EXP[i])])  # (x - alpha^i); - == + in GF(2)
    return np.array(g, np.int32)  # degree 60, g[0] = 1


_GEN = _generator_poly()


def rs_encode(info: np.ndarray) -> np.ndarray:
    """58 information octets -> 118-octet systematic codeword
    (info followed by 60 parity octets)."""
    info = np.asarray(info, np.int32)
    assert info.shape == (K_INFO,) and (info >= 0).all() and (info < 256).all()
    # polynomial division of info(x) * x^60 by g(x)
    rem = np.zeros(N_PARITY, np.int32)
    for a in info:
        feedback = int(rem[0]) ^ int(a)
        rem[:-1] = rem[1:]
        rem[-1] = 0
        if feedback:
            lf = _LOG[feedback]
            for j in range(N_PARITY):
                gj = int(_GEN[j + 1])
                if gj:
                    rem[j] ^= int(_EXP[lf + _LOG[gj]])
    return np.concatenate([info, rem]).astype(np.uint8)


def _syndromes(code: np.ndarray) -> np.ndarray:
    """S_i = c(alpha^i), i = 0..59, with c(x) as in the module docstring
    (code[j] is the coefficient of x^(117-j))."""
    s = np.zeros(N_PARITY, np.int32)
    for i in range(N_PARITY):
        acc = 0
        for c in code:
            acc = _gmul(acc, int(_EXP[i])) ^ int(c)
        s[i] = acc
    return s



def _locator_poly(xs: list[int]) -> list[int]:
    """prod_k (1 + X_k x); returned low-to-high (out[i] = coeff of x^i)."""
    lam = [1]
    for xk in xs:
        new = lam + [0]
        for i in range(len(lam), 0, -1):
            new[i] ^= _gmul(lam[i - 1], xk)
        lam = new
    return lam


def _mod_syndromes(poly: list[int], syn: np.ndarray) -> list[int]:
    """poly(x) * S(x) mod x^60, with S(x) = sum S_i x^i."""
    out = [0] * N_PARITY
    for i in range(N_PARITY):
        acc = 0
        for j in range(min(i + 1, len(poly))):
            acc ^= _gmul(poly[j], int(syn[i - j]))
        out[i] = acc
    return out


def _poly_eval(poly: list[int], x: int) -> int:
    acc = 0
    for c in reversed(poly):
        acc = _gmul(acc, x) ^ c
    return acc


def _forney_correct(code: np.ndarray, positions: list[int],
                    locator: list[int], omega: list[int]) -> None:
    """In-place Forney correction at the given codeword positions
    (first consecutive root alpha^0 -> e_k = X_k * Omega/Locator')."""
    for pos in positions:
        xk = int(_EXP[(N_CODE - 1 - pos) % 255])
        xinv = _gdiv(1, xk)
        om = _poly_eval(omega, xinv)
        # derivative of the locator: odd-degree terms survive in GF(2)
        dloc = 0
        for i in range(1, len(locator), 2):
            pw = 1
            for _ in range(i - 1):
                pw = _gmul(pw, xinv)
            dloc ^= _gmul(locator[i], pw)
        if dloc == 0:
            raise ValueError("locator derivative vanished")
        code[pos] ^= _gmul(xk, _gdiv(om, dloc))


def rs_decode_erasures(code: np.ndarray, erased: list[int]) -> np.ndarray:
    """Erasures-only decoding: reconstruct the codeword given <= 60
    erased positions (indices into the 118-octet codeword; their current
    values are ignored).  Returns the corrected 118-octet codeword.
    Raises ValueError if the syndromes are inconsistent (i.e. the
    non-erased octets themselves carry errors beyond what 60 checks can
    explain)."""
    code = np.asarray(code, np.int32).copy()
    erased = sorted(set(int(e) for e in erased))
    assert all(0 <= e < N_CODE for e in erased)
    if len(erased) > N_PARITY:
        raise ValueError(f"{len(erased)} erasures > {N_PARITY} correctable")
    code[erased] = 0
    syn = _syndromes(code)
    if not erased:
        if syn.any():
            raise ValueError("syndromes nonzero with no erasures")
        return code.astype(np.uint8)

    # erasure locator from X_k = alpha^(117 - pos), Omega = S*Lambda
    # mod x^60, then Forney at the erased positions (helpers shared
    # with the errors-and-erasures decoder)
    xs = [int(_EXP[(N_CODE - 1 - e) % 255]) for e in erased]
    lam = _locator_poly(xs)
    omega = _mod_syndromes(lam, syn)
    _forney_correct(code, erased, lam, omega)

    if _syndromes(code).any():
        raise ValueError("residual syndromes after erasure correction")
    return code.astype(np.uint8)


# --- CED <-> octets ----------------------------------------------------

# (field, bits) in word order; values are the already-quantized unsigned
# field integers as the word builders emit them (inav.generate_page_pair)
CED_FIELDS = (
    ("toe", 14), ("m0", 32), ("e", 32), ("sqrta", 32),          # word 1
    ("omg0", 32), ("inc0", 32), ("aop", 32), ("idot", 14),      # word 2
    ("omgdot", 24), ("deltan", 16), ("cuc", 16), ("cus", 16),   # word 3
    ("crc", 16), ("crs", 16), ("sisa", 8),
    ("cic", 16), ("cis", 16), ("toc", 14),                      # word 4
    ("af0", 31), ("af1", 21), ("af2", 6),
)
_CED_BITS = sum(b for _, b in CED_FIELDS)  # 436 field bits (+16 header = 452)
assert _CED_BITS + 12 == (K_INFO - 2) * 8  # 448 payload bits + 2 header octets


def ced_info_octets(svid: int, iodnav: int, fields: dict) -> np.ndarray:
    """Pack the quantized CED field integers into the 58 RS information
    octets (layout in the module docstring)."""
    from .inav import BitWriter

    w = BitWriter(K_INFO * 8)
    w.put(svid & 0x3F, 6)
    w.put(iodnav & 0x3FF, 10)
    for name, bits in CED_FIELDS:
        w.put(int(fields[name]) & ((1 << bits) - 1), bits)
    w.put(0, 12)  # pad
    return np.packbits(w.bits).astype(np.uint8)


def rs_decode(code: np.ndarray, erased: list[int] | None = None) -> np.ndarray:
    """Errors-AND-erasures decoding: corrects e erasures (known
    positions) plus t unknown-position errors whenever 2t + e <= 60.

    Berlekamp-Massey on the erasure-modified syndromes finds the error
    locator; Chien search over the 118 valid positions locates errors;
    Forney with the combined locator computes magnitudes.  Raises
    ValueError when the pattern exceeds the code's capability (residual
    syndromes / locator degree mismatch) instead of returning a
    miscorrection."""
    code = np.asarray(code, np.int32).copy()
    erased = sorted(set(int(e) for e in (erased or [])))
    assert all(0 <= e < N_CODE for e in erased)
    if len(erased) > N_PARITY:
        raise ValueError(f"{len(erased)} erasures > {N_PARITY} correctable")
    code[erased] = 0
    syn = _syndromes(code)
    if not syn.any():
        return code.astype(np.uint8)

    xs = [int(_EXP[(N_CODE - 1 - e) % 255]) for e in erased]
    gam = _locator_poly(xs)  # erasure locator Gamma(x)
    xi = _mod_syndromes(gam, syn)  # modified syndromes Xi = S*Gamma

    # Berlekamp-Massey over xi[e:] for the error locator Lambda(x)
    e_cnt = len(erased)
    lam = [1]
    prev = [1]
    L = 0
    m = 1
    b = 1
    for n in range(N_PARITY - e_cnt):
        d = xi[n + e_cnt]
        for i in range(1, L + 1):
            if i < len(lam):
                d ^= _gmul(lam[i], xi[n + e_cnt - i])
        if d == 0:
            m += 1
        elif 2 * L <= n:
            t_poly = list(lam)
            coef = _gdiv(d, b)
            shifted = [0] * m + [_gmul(coef, c) for c in prev]
            lam = [
                (lam[i] if i < len(lam) else 0)
                ^ (shifted[i] if i < len(shifted) else 0)
                for i in range(max(len(lam), len(shifted)))
            ]
            L = n + 1 - L
            prev = t_poly
            b = d
            m = 1
        else:
            coef = _gdiv(d, b)
            shifted = [0] * m + [_gmul(coef, c) for c in prev]
            lam = [
                (lam[i] if i < len(lam) else 0)
                ^ (shifted[i] if i < len(shifted) else 0)
                for i in range(max(len(lam), len(shifted)))
            ]
            m += 1
    if 2 * L + e_cnt > N_PARITY:
        raise ValueError("error pattern exceeds 2t + e <= 60")

    # Chien search: error positions are codeword indices whose locator
    # X = alpha^(117 - pos) satisfies Lambda(X^-1) == 0
    err_pos = []
    for pos in range(N_CODE):
        if pos in erased:
            continue
        xinv = int(_EXP[(255 - (N_CODE - 1 - pos)) % 255])
        if _poly_eval(lam, xinv) == 0:
            err_pos.append(pos)
    if len(err_pos) != L:
        raise ValueError(
            f"locator degree {L} but {len(err_pos)} roots — uncorrectable"
        )

    # combined locator Psi = Lambda * Gamma; Omega = S * Psi mod x^60
    psi = _poly_mul(lam, gam)
    omega = _mod_syndromes(psi, syn)
    _forney_correct(code, erased + err_pos, psi, omega)

    if _syndromes(code).any():
        raise ValueError("residual syndromes after correction")
    return code.astype(np.uint8)


# field layout inside each CED word's content bits, AFTER the 8-bit
# folded header+type field (matches inav.generate_page_pair exactly)
_WORD_SPANS = {
    1: (("iodnav", 10), ("toe", 14), ("m0", 32), ("e", 32), ("sqrta", 32)),
    2: (("iodnav", 10), ("omg0", 32), ("inc0", 32), ("aop", 32),
        ("idot", 14)),
    3: (("iodnav", 10), ("omgdot", 24), ("deltan", 16), ("cuc", 16),
        ("cus", 16), ("crc", 16), ("crs", 16), ("sisa", 8)),
    4: (("iodnav", 10), ("svid", 6), ("cic", 16), ("cis", 16),
        ("toc", 14), ("af0", 31), ("af1", 21), ("af2", 6)),
}

# bit offsets of each field inside the 464-bit info block
_INFO_OFFSET = {"svid": 0, "iodnav": 6}
_pos = 16
for _name, _bits in CED_FIELDS:
    _INFO_OFFSET[_name] = _pos
    _pos += _bits
_FIELD_BITS = dict(CED_FIELDS)
_FIELD_BITS["svid"] = 6
_FIELD_BITS["iodnav"] = 10


def codeword_from_words(contents: dict) -> tuple[np.ndarray, list[int]]:
    """Assemble the 118-octet RS codeword from decoded I/NAV words.

    `contents` maps word_type -> the word's content bitstream (the
    130-bit writer stream starting at the folded header+type field,
    rx_pvt.page_content) for any subset of {1, 2, 3, 4, 17, 18, 19,
    20}.  Returns (codeword with unknown octets zeroed, erased
    positions) ready for rs_decode_erasures — an info octet counts as
    known only when every bit of it came from a received word."""
    bits = np.zeros(K_INFO * 8, np.uint8)
    known = np.zeros(K_INFO * 8, bool)
    known[_CED_BITS + 16 :] = True  # pad bits are zero by construction

    def put(name: str, value: int) -> None:
        off, n = _INFO_OFFSET[name], _FIELD_BITS[name]
        for i in range(n):
            bits[off + i] = (value >> (n - 1 - i)) & 1
        known[off : off + n] = True

    for wt, spans in _WORD_SPANS.items():
        c = contents.get(wt)
        if c is None:
            continue
        c = np.asarray(c).ravel()
        pos = 8  # skip the folded header+type field
        for name, n in spans:
            v = 0
            for b in c[pos : pos + n]:
                v = (v << 1) | int(b)
            pos += n
            put(name, v)

    code = np.zeros(N_CODE, np.uint8)
    erased: list[int] = []
    octets = np.packbits(bits)
    for i in range(K_INFO):
        if known[8 * i : 8 * i + 8].all():
            code[i] = octets[i]
        else:
            erased.append(i)
    for wt in (17, 18, 19, 20):
        base = K_INFO + 15 * (wt - 17)
        c = contents.get(wt)
        if c is None:
            erased.extend(range(base, base + 15))
            continue
        c = np.asarray(c).ravel()
        for j in range(15):
            v = 0
            for b in c[8 + 8 * j : 16 + 8 * j]:
                v = (v << 1) | int(b)
            code[base + j] = v
    return code, erased


def info_octets_to_ced(octets: np.ndarray) -> tuple[int, int, dict]:
    """Inverse of ced_info_octets -> (svid, iodnav, raw unsigned field
    integers)."""
    bits = np.unpackbits(np.asarray(octets, np.uint8))
    pos = 0

    def take(n):
        nonlocal pos
        v = 0
        for b in bits[pos : pos + n]:
            v = (v << 1) | int(b)
        pos += n
        return v

    svid = take(6)
    iodnav = take(10)
    fields = {name: take(nbits) for name, nbits in CED_FIELDS}
    return svid, iodnav, fields
