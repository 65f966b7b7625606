"""The conversion-free main loop of csrc/synth_kp_v5.cu, emulated in
numpy float32: each formula that replaced a type conversion gives the
old formula's value bit for bit, over its whole domain.

The old main loop converted small exact integers to float32 (I2F of the
int8 taps, of the carry bits, of the symbol bits and of K0 + rho) and
back (F2I of delta and j6 for the CBOC parity).  The new one builds the
same values with a byte permute under the exponent of 2^23, selects, a
float counter and the lowest mantissa bit of x + 1.5*2^23.  Equal
values give equal bits through the inexact operations that follow, so
these checks plus the recorded digests (tests/test_torch_cuda.py) are
the same-bits argument.  Both FMA contractions (-fmad=true and false)
are emulated where an expression could be contracted.

The prologue kernel's planes: `kp_planes_ref` against the plain
version's own prologue, the scratch layout, and the policy that sizes
the main kernel's K chunks.  No JAX here.
"""

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu_torch.harness import synthetic_kp_inputs
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

F32 = np.float32
MAGIC23 = F32(2.0**23)
CHIP_BIAS = 2
# delta = floor(t_kp): the integers around the chip edges, past the
# code-Doppler envelope (the distributed path has no MU_MAX fallback),
# and floor(-0.0)
DELTAS = np.array(list(range(-4, 5)) + [-0.0], F32)
CHIPS = (-1, 0, 1)


def bits(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


def fma(a, b, c):
    """float32 fma: the float64 product of two float32 values is exact,
    and every sum here is of values far inside float64's range."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def mul_add(a, b, c, contract: bool):
    """a*b + c as nvcc builds it: one fma under -fmad=true, else a
    rounded product and a rounded sum."""
    return fma(a, b, c) if contract else (F32(a) * F32(b) + F32(c)).astype(F32)


# --- the kernel's new formulas, in numpy --------------------------------


def chip_byte(v):
    return np.uint32(v + CHIP_BIAS)


def chip_word(a0b, a1b, a0c, a1c):
    """The prologue's chip word: a0b, a1b - a0b, a0c, a1c - a0c."""
    return (chip_byte(a0b) | chip_byte(a1b - a0b) << np.uint32(8) | chip_byte(a0c) << np.uint32(16)
            | chip_byte(a1c - a0c) << np.uint32(24))


def chip_val(w, byte: int):
    """__byte_perm(w, 0x4B000000, 0x7540 | byte) as a float, minus
    2^23 + CHIP_BIAS."""
    w = np.asarray(w, np.uint32)
    perm = ((w >> np.uint32(8 * byte)) & np.uint32(0xFF)) | np.uint32(0x4B000000)
    return (perm.view(F32) - (MAGIC23 + F32(CHIP_BIAS))).astype(F32)


def bit01(word, bit):
    return np.where((np.asarray(word, np.uint32) >> np.uint32(bit)) & np.uint32(1), F32(1), F32(0))


def pm1(word, bit):
    return np.where((np.asarray(word, np.uint32) >> np.uint32(bit)) & np.uint32(1), F32(-1), F32(1))


def parity(x):
    return bits((np.asarray(x, F32) + F32(1.5) * MAGIC23).astype(F32)) & np.uint32(1)


# --- the checks ---------------------------------------------------------


@pytest.mark.parametrize("contract", [True, False])
def test_chip_taps_from_the_byte_permute(contract):
    """chip = a0 + delta*(a1 - a0) for every pair of taps in {-1, 0, 1}
    and every delta: the taps as PRMT'd bytes equal the int8->float
    conversions, and the chip value is the same float."""
    taps = np.array(np.meshgrid(CHIPS, CHIPS, CHIPS, CHIPS, indexing="ij")).reshape(4, -1)
    w = chip_word(*taps)
    for a0, a1, byte in ((taps[0], taps[1], 0), (taps[2], taps[3], 2)):
        old_a0, old_a1 = a0.astype(F32), a1.astype(F32)
        new_a0, new_da = chip_val(w, byte), chip_val(w, byte + 1)
        assert np.array_equal(bits(new_a0), bits(old_a0))
        assert np.array_equal(bits(new_da), bits((old_a1 - old_a0).astype(F32)))
        for delta in DELTAS:
            old = mul_add(delta, (old_a1 - old_a0).astype(F32), old_a0, contract)
            new = mul_add(delta, new_da, new_a0, contract)
            assert np.array_equal(bits(new), bits(old)), delta


def test_chip_word_bytes_cover_every_value():
    """Every value a byte may hold, -2..2, comes back exactly from each
    of the four byte positions."""
    for v in range(-2, 3):
        for byte in range(4):
            w = chip_byte(v) << np.uint32(8 * byte)
            assert bits(chip_val(w, byte)) == bits(F32(v))


@pytest.mark.parametrize("contract", [True, False])
def test_carry_select_from_the_stored_difference(contract):
    """bsel = b0 + delta*(b1 - b0) with b1 - b0 stored as one bit: for
    every gbm the prologue can see (integers 0..8183, with the float32
    compare of gbm + 1), b1 >= b0, and the selects give the old value."""
    gbm = np.concatenate([np.arange(-2, 8190, dtype=F32), F32([0.5, 1022.5, 8183.75, np.nan])])
    for rho in range(8):
        thr = F32(1023) * (F32(8) - F32(rho))
        b0 = (gbm >= thr).astype(np.uint32)
        b1 = ((gbm + F32(1)).astype(F32) >= thr).astype(np.uint32)
        assert (b1 >= b0).all()
        word = b0 << np.uint32(rho) | (b1 - b0) << np.uint32(8 + rho)
        for delta in DELTAS:
            old = mul_add(delta, (b1.astype(F32) - b0.astype(F32)).astype(F32), b0.astype(F32), contract)
            new = mul_add(delta, bit01(word, 8 + rho), bit01(word, rho), contract)
            assert np.array_equal(bits(new), bits(old)), (rho, delta)


def test_symbol_select():
    """pm1: 1 - 2*(float)((w >> (kap + i)) & 1) on the signed word
    equals the select on (unsigned)w >> kap, bit i, for every kap the
    launch allows (kap + 2 < 32) and words with the sign bit set."""
    rng = np.random.default_rng(0)
    words = np.concatenate([rng.integers(-2**31, 2**31, 4096), [0, -1, -2**31, 2**31 - 1]]).astype(np.int32)
    for kap in range(30):
        for i in range(3):
            old_bit = (words >> np.int32(kap + i)) & np.int32(1)
            old = (F32(1) - F32(2) * old_bit.astype(F32)).astype(F32)
            new = pm1(words.view(np.uint32) >> np.uint32(kap), i)
            assert np.array_equal(bits(new), bits(old)), (kap, i)


def test_cboc_parity_from_the_float_bits():
    """tau's parity: pgb + (rho & 1) + (int)delta + (int)j6 against the
    lowest mantissa bit of (delta + j6) + 1.5*2^23, for every delta in
    [-4, 4] (and -0.0), j6 in [0, 6], pgb and rho."""
    for delta in DELTAS:
        for j6 in range(7):
            for pgb in (0, 1):
                for rho in range(8):
                    old = (pgb + (rho & 1) + int(delta) + j6) & 1
                    new = int(parity(F32(delta) + F32(j6))) ^ pgb ^ (rho & 1)
                    assert new == old, (delta, j6, pgb, rho)


def test_parity_holds_while_delta_stays_below_2_22():
    """The bound the kernel states: exact for every integer |x| < 2^22."""
    x = np.arange(-(2**22) + 1, 2**22, dtype=np.int64)
    assert np.array_equal(parity(x.astype(F32)), (x & 1).astype(np.uint32))


def test_row_counter_in_float():
    """k0f, counted up by 8.0 from a multiple of 8, plus rho equals
    (float)(K0 + rho) for every K in [0, 2^16)."""
    kap = np.arange(2**13)
    k0f = np.cumsum(np.full(kap.size, F32(8)), dtype=F32) - F32(8)
    for rho in range(8):
        assert np.array_equal(bits(k0f + F32(rho)), bits((8 * kap + rho).astype(F32)))


@pytest.mark.parametrize("cboc", [False, True])
@pytest.mark.parametrize("contract", [True, False])
def test_whole_body_same_bits(cboc, contract):
    """One (channel, row) body of the main loop, old conversions against
    new formulas, on 200000 random operands (taps, bits, symbols, t_kp
    out to |delta| = 4): the mix m, and so every product after it."""
    rng = np.random.default_rng(1 + cboc + 2 * contract)
    n = 200000
    a = rng.integers(-1, 2, (4, n))
    b0 = rng.integers(0, 2, n).astype(np.uint32)
    b1 = np.maximum(b0, rng.integers(0, 2, n).astype(np.uint32))
    rho = rng.integers(0, 8, n)
    pgb = rng.integers(0, 2, n).astype(np.uint32)
    t_kp = rng.uniform(-4, 5, n).astype(F32)
    t_kp[:64] = np.floor(t_kp[:64])  # on the chip edges
    d_lo, d_df = rng.choice(F32([-1, 1]), n), rng.choice(F32([-2, 0, 2]), n)
    s_lo, s_df = rng.choice(F32([-1, 1]), n), rng.choice(F32([-2, 0, 2]), n)
    w_plus, w_minus = F32(0.9), F32(0.3)
    delta = np.floor(t_kp).astype(F32)

    def mix(chip_b, chip_c, bsel, tau_pos):
        d_val = mul_add(bsel, d_df, d_lo, contract)
        s_val = mul_add(bsel, s_df, s_lo, contract)
        if not cboc:
            return (chip_b * d_val - chip_c * s_val).astype(F32)
        wb = np.where(tau_pos, w_plus, w_minus)
        wc = np.where(tau_pos, w_minus, w_plus)
        return ((chip_b * wb).astype(F32) * d_val - (chip_c * wc).astype(F32) * s_val).astype(F32)

    af = a.astype(F32)
    frac = (t_kp - delta).astype(F32)
    j6 = np.floor(F32(6) * frac).astype(F32)
    old = mix(mul_add(delta, af[1] - af[0], af[0], contract),
              mul_add(delta, af[3] - af[2], af[2], contract),
              mul_add(delta, b1.astype(F32) - b0.astype(F32), b0.astype(F32), contract),
              ((pgb + (rho & 1) + delta.astype(np.int64) + j6.astype(np.int64)) & 1) == 0)
    w = chip_word(a[0], a[1], a[2], a[3])
    word = b0 << rho.astype(np.uint32) | (b1 - b0) << (8 + rho).astype(np.uint32)
    new = mix(mul_add(delta, chip_val(w, 1), chip_val(w, 0), contract),
              mul_add(delta, chip_val(w, 3), chip_val(w, 2), contract),
              mul_add(delta, bit01(word, 8 + rho), bit01(word, rho), contract),
              (parity(delta + j6) ^ pgb ^ (rho & 1).astype(np.uint32)) == 0)
    assert np.array_equal(bits(new), bits(old))


# --- the prologue kernel's planes and the grid -------------------------


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("C", [1, 2, 8, 16])
def test_k_chunk_policy(B, C):
    """A multiple of 8 rows, within the shared memory of a block, and at
    least two blocks per SM of an H100 wherever 8 rows can give them;
    today's 40 rows at B = 8."""
    k = synth_kp_cuda.k_chunk(B, C, 200)
    blocks = synth_kp_cuda.P_TILES * B * -(-200 // k)
    assert k % 8 == 0 and 8 <= k <= synth_kp_cuda.K_CHUNK
    assert synth_kp_cuda.smem_bytes(C, k) <= synth_kp_cuda.SMEM_LIMIT
    assert blocks >= synth_kp_cuda.MIN_BLOCKS == 264
    if B == 1:
        assert (k, blocks) == (8, 275)
    if B == 8:
        assert (k, blocks) == (40, 440)
    assert synth_kp_cuda.k_chunk(B, C, 8) == 8


@pytest.mark.parametrize("cboc", [False, True])
@pytest.mark.parametrize("case", ["random", "edges", "negated_mu"])
def test_planes_ref_encodes_the_plain_prologue(cboc, case):
    """kp_planes_ref holds, in the kernel's encodings, exactly the planes
    the plain version (synth_kp_packed_ref) computes: the byte-permute
    decode of each chip word gives a0 and a1 - a0 of both codes, the bits
    word b0, b1 - b0 and parity(gb), and cisk the main loop's K factor."""
    t = synthetic_kp_inputs(2, 8, 21, case, torch.device("cpu"), cboc=cboc)
    planes = tkp.kp_planes_ref(t, 16)
    pro = tkp._prologue(t)
    assert planes["plf"].dtype == torch.float32 and planes["plf"].shape == (2, 8, 1300, 4)
    for i, key in enumerate(("psi", "w8", "cpr", "cpi")):
        assert torch.equal(planes["plf"][..., i], pro[key])
    words = planes["chip"].numpy().astype(np.int64).astype(np.uint32)  # (B, C, 8, P)
    taps = pro["taps"].numpy()
    for code, base in ((0, 0), (1, 16)):
        a0, a1 = taps[:, :, base:base + 8], taps[:, :, base + 8:base + 16]
        assert np.array_equal(chip_val(words, 2 * code), a0)
        assert np.array_equal(chip_val(words, 2 * code + 1), a1 - a0)
    word = planes["bits"].numpy().view(np.uint32)[:, :, None, :]
    rho = np.arange(8, dtype=np.uint32)[:, None]
    assert np.array_equal(bit01(word >> rho, 0), pro["b0"].numpy())
    assert np.array_equal(bit01(word >> rho, 8), (pro["b1"] - pro["b0"]).numpy())
    gb = pro["gb"].numpy()
    assert np.array_equal(bit01(word[:, :, 0], 16), np.abs(np.fmod(gb, 2)).astype(F32))
    ckr, cki = tkp._cis_k(t, 16)
    assert torch.equal(planes["cisk"], torch.stack([ckr, cki], dim=-1))


def test_decode_planes_follows_the_scratch_layout():
    """A scratch written in the layout the source documents (per (b, c)
    over 1408 columns: float4 plf, two uint4 of chip words, the bits
    word; then the float2 K factors) decodes to the planes it holds."""
    B, C, n_k, pad = 2, 3, 16, 1408
    rng = np.random.default_rng(3)
    plf = rng.standard_normal((B, C, pad, 4)).astype(F32)
    chip = rng.integers(0, 2**31, (B, C, 8, pad)).astype(np.int32)
    bits = rng.integers(0, 2**17, (B, C, pad)).astype(np.int32)
    cisk = rng.standard_normal((B, C, n_k, 2)).astype(F32)
    chip_uint4 = chip.reshape(B, C, 2, 4, pad).transpose(0, 1, 2, 4, 3)  # [b][c][h][p][4]
    raw = np.concatenate([plf.view(np.int32).ravel(), chip_uint4.ravel(), bits.ravel(),
                          cisk.view(np.int32).ravel()])
    assert raw.nbytes == synth_kp_cuda.planes_bytes(B, C, n_k)
    got = synth_kp_cuda.decode_planes(torch.from_numpy(raw.view(np.uint8)), B, C, n_k)
    assert np.array_equal(got["plf"].numpy(), plf[:, :, :1300])
    assert np.array_equal(got["chip"].numpy(), chip[..., :1300])
    assert np.array_equal(got["bits"].numpy(), bits[..., :1300])
    assert np.array_equal(got["cisk"].numpy(), cisk)


def test_kp_planes_on_the_cpu_is_the_plain_version():
    t = synthetic_kp_inputs(1, 2, 5, "random", torch.device("cpu"))
    before = dict(synth_kp_cuda.launch_counts)
    got = synth_kp_cuda.kp_planes(t, 8)
    ref = tkp.kp_planes_ref(t, 8)
    assert synth_kp_cuda.launch_counts == before
    assert all(torch.equal(got[k], ref[k]) for k in ref)
