"""Wrapper of the hand-written CUDA kernels of csrc/synth_kp_v5.cu.

They replace the Pallas TPU kernel `_kernel_v5`
(galileo_sdr_sim_tpu/ops/synth_kp_pallas.py): a prologue kernel
(`kp_planes_kernel`, the kernel's per-(channel, p) planes) and the main
kernel in six instantiations, chosen by the operands and the emit:
sine-BOC or CBOC (`cboc_ab` in the inputs), without or with per-channel
gain (`chan_gain`), packed or float32.  Every call launches both through
one entry point of the library (`synth_kp_v5_pair_launch`), on the
current stream, with a planes scratch allocated here: the prologue, one
thread a column with the K factors in blocks of their own, and the main
kernel as its programmatic dependent (its blocks are set up while the
prologue runs and wait on the grid dependency before they read the
planes).  The operands are checked once a call.  Every instantiation runs the TPU kernel's K-vectorised main loop
(`vec_kt=True`, synth_kp_pallas.py:180-259), whose values are those of
its default per-row loop bit for bit, so there is no `vec_kt` option
here.  Per block of B epochs `synth_kp_packed` writes (B, n_k, 1300)
int32 packed I/Q; `synth_kp_int16` is the same store viewed as
(B, 2*n_k*1300) interleaved int16 (the TPU kernel's emit="int16");
`synth_kp_accum` writes the untruncated (B, n_k*1300, 2) float32
accumulator (emit="f32", sine-BOC or CBOC, no gain) that the sat-sharded
mesh path all-reduces; `kp_planes` runs the prologue alone.  The main
kernel takes K in chunks of `k_chunk(B, C)` rows, so that the grid fills
the card at B = 1 (live mode) as at B = 8.  See the source for the
design and what bounds it.

Each wrapper launches the kernels for CUDA tensors and runs the plain
PyTorch version (ops/synth_kp.synth_kp_packed_ref, synth_kp_accum_ref,
kp_planes_ref) for CPU tensors only.  On a CUDA tensor it launches or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .synth_kp import (
    GAIN_OPERAND, INT_OPERANDS, K_EPOCH, P_GRID, ROWS, SCALAR_OPERANDS, SYM_BITS, T_RS, W_RS,
    iq16_view, kp_planes_ref, synth_kp_accum_ref, synth_kp_packed_ref,
)

SOURCE = "synth_kp_v5"
_PALLAS = "galileo_sdr_sim_tpu/ops/synth_kp_pallas.py"
PLANES = "synth_kp_v5_planes"  # the prologue kernel
# the operands the prologue reads, in the order of its launch
PLANE_OPERANDS = ("cp0", "two_a", "mu", "g0", "o", "r", "carr0", "fc", "fc_k")
# kernel -> file:line of the part of `_kernel_v5` it replaces: the main
# kernel's instantiations replace the kernel (sine-BOC) and its
# use_gain=True, cboc=True (with and without gain) and emit="f32"
# (sine-BOC and CBOC) branches; the prologue kernel its per-(c, p)
# prologue
REPLACES = {
    "synth_kp_v5": f"{_PALLAS}:74",
    "synth_kp_v5_gain": f"{_PALLAS}:307",
    "synth_kp_v5_cboc": f"{_PALLAS}:294",
    "synth_kp_v5_cboc_gain": f"{_PALLAS}:294",
    "synth_kp_v5_f32": f"{_PALLAS}:342",
    "synth_kp_v5_cboc_f32": f"{_PALLAS}:342",
    PLANES: f"{_PALLAS}:124",
}
INT16_REPLACES = f"{_PALLAS}:337"  # emit="int16"
# FMA contraction of a*b + c (nvcc -fmad): kept on, the build that lies
# closer to the JAX engine on the fixture scene, whose XLA lowering fuses
# the p-phase multiply-adds too (PERF.md, FMA-contraction finding)
FMAD = True
P_TILE = 128  # columns p a block of the main kernel takes
P_TILES = -(-P_GRID // P_TILE)  # 11 blocks along p
K_CHUNK = 40  # most K rows a block of the main kernel takes
MIN_BLOCKS = 2 * 132  # two blocks per SM of an H100
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

# launches in this process (read and reset by chip_smoke.py): the total
# of the main kernel, per kernel (each instantiation, and the prologue
# under PLANES), and the main-kernel launches made for the int16 view
launch_count = 0
launch_counts = dict.fromkeys(REPLACES, 0)
int16_launch_count = 0

_libs: dict[bool, tuple[ctypes.CDLL, _build.Built]] = {}


def reset_counts() -> None:
    global launch_count, int16_launch_count
    launch_count = int16_launch_count = 0
    launch_counts.update(dict.fromkeys(REPLACES, 0))


def smem_bytes(C: int, k_chunk: int) -> int:
    """Shared memory of one main-kernel block (the source's smem_bytes):
    per channel a 128-column tile of the planes (52 bytes a column), the
    K factors of its k_chunk rows and four scalars."""
    return C * P_TILE * (16 + 32 + 4) + C * k_chunk * 8 + C * 16


def planes_bytes(B: int, C: int, n_k: int) -> int:
    """Bytes of the planes scratch (the source's planes_bytes): per
    (epoch, channel) 52 bytes a column over 11 x 128 columns and one
    float2 K factor a row."""
    return B * C * (P_TILES * P_TILE * 52 + n_k * 8)


def k_chunk(B: int, C: int, n_k: int = K_EPOCH) -> int:
    """K rows a main-kernel block takes: the largest multiple of 8, at
    most K_CHUNK, that still gives MIN_BLOCKS blocks (11 x B x chunks)
    within SMEM_LIMIT; 8 when none does.  40 at B = 8 (440 blocks), 8
    at B = 1 (275)."""
    for k in range(min(K_CHUNK, n_k) // ROWS * ROWS, 0, -ROWS):
        if P_TILES * B * -(-n_k // k) >= MIN_BLOCKS and smem_bytes(C, k) <= SMEM_LIMIT:
            return k
    return ROWS


def launch_geometry(B: int, C: int, n_k: int = K_EPOCH) -> tuple:
    """((grid, threads) of the prologue, (grid, threads) of the main
    kernel) of one call (the source's synth_kp_v5_geometry): the prologue
    takes the 11 column tiles and then the K-factor blocks of every
    (b, c), the main kernel 11 column tiles by B epochs by the K chunks."""
    chunk = k_chunk(B, C, n_k)
    return (((P_TILES + -(-n_k // P_TILE), B, C), P_TILE),
            ((P_TILES, B, -(-n_k // chunk)), P_TILE))


def instantiation(inputs: dict, f32: bool = False) -> str:
    """The kernel instantiation the operands and the emit select."""
    name = "synth_kp_v5"
    if "cboc_ab" in inputs:
        name += "_cboc"
    if GAIN_OPERAND in inputs:
        name += "_gain"
    if f32:
        name += "_f32"
    return name


def library(fmad: bool = FMAD) -> tuple[ctypes.CDLL, _build.Built]:
    """Build (at first use) and load the kernel library."""
    if fmad not in _libs:
        built = _build.build(SOURCE, (f"-fmad={'true' if fmad else 'false'}",))
        lib = _build.load(built)
        lib.synth_kp_v5_planes_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.synth_kp_v5_planes_launch.restype = ctypes.c_int
        lib.synth_kp_v5_pair_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_float] * 2 + [ctypes.c_int] * 7
            + [ctypes.c_void_p]
        )
        lib.synth_kp_v5_pair_launch.restype = ctypes.c_int
        lib.synth_kp_v5_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.synth_kp_v5_smem_bytes.restype = ctypes.c_size_t
        lib.synth_kp_v5_planes_bytes.argtypes = [ctypes.c_int] * 3
        lib.synth_kp_v5_planes_bytes.restype = ctypes.c_size_t
        lib.synth_kp_v5_geometry.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.synth_kp_v5_geometry.restype = None
        lib.synth_kp_v5_error_string.argtypes = [ctypes.c_int]
        lib.synth_kp_v5_error_string.restype = ctypes.c_char_p
        _libs[fmad] = (lib, built)
    return _libs[fmad]


_WANT = {name: torch.int32 if name in INT_OPERANDS else torch.float32
         for name in (*SCALAR_OPERANDS, GAIN_OPERAND)}
_WITH_GAIN = SCALAR_OPERANDS + (GAIN_OPERAND,)


def _check(inputs: dict, n_k: int) -> tuple[int, int]:
    """Raise on operands the kernels do not take -> (B, C).  It runs once
    a call, on the host, before anything is launched."""
    cp0 = inputs["cp0"]
    if cp0.dim() != 2:
        raise ValueError(f"cp0 must be (B, C), got {tuple(cp0.shape)}")
    shape, device = cp0.shape, cp0.device
    B, C = shape
    for name in _WITH_GAIN if GAIN_OPERAND in inputs else SCALAR_OPERANDS:
        t = inputs[name]
        if t.dtype is not _WANT[name] or t.shape != shape:
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, want {_WANT[name]}({B}, {C})")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
    if "cboc_ab" in inputs:
        ab = inputs["cboc_ab"]
        if ab.dtype is not torch.float32 or ab.shape != (2,) or ab.device.type != "cpu":
            raise ValueError(
                f"cboc_ab: {ab.dtype}{tuple(ab.shape)} on {ab.device}, "
                "want a float32 (2,) host tensor (alpha, beta)"
            )
    tab = inputs["vpack_rs"]
    if tab.dtype is not torch.int8 or tab.shape != (C, W_RS, T_RS):
        raise ValueError(f"vpack_rs: {tab.dtype}{tuple(tab.shape)}, want int8({C}, {W_RS}, {T_RS})")
    if tab.device != device or not tab.is_contiguous():
        raise ValueError(f"vpack_rs must be contiguous on {device}")
    if n_k <= 0 or n_k % ROWS != 0 or n_k // ROWS + 2 > SYM_BITS:
        raise ValueError(f"n_k={n_k}: need a positive multiple of {ROWS} with n_k/8 + 2 <= 32")
    return B, C


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.synth_kp_v5_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _launch_planes(lib: ctypes.CDLL, inputs: dict, n_k: int) -> torch.Tensor:
    """Launch the prologue alone on the current stream of the inputs'
    device into a planes scratch allocated here, which it returns."""
    B, C = _check(inputs, n_k)
    device = inputs["cp0"].device
    planes = torch.empty(planes_bytes(B, C, n_k), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.synth_kp_v5_planes_launch(
            *(inputs[k].data_ptr() for k in PLANE_OPERANDS),
            inputs["vpack_rs"].data_ptr(), planes.data_ptr(), B, C, n_k, T_RS, stream)
    _raise_on(lib, err, "synth_kp_v5 prologue")
    launch_counts[PLANES] += 1
    return planes


def _launch(lib: ctypes.CDLL, inputs: dict, n_k: int, f32: bool = False) -> torch.Tensor:
    """One call of `lib`'s entry point for the pair: the prologue and then
    the instantiation the operands select, on the current stream of the
    inputs' device; the output and the planes scratch are allocated
    here, nothing is synchronized.  `f32`: the float32 store,
    (B, n_k*1300, 2); else the packed one, (B, n_k, 1300) int32."""
    global launch_count
    B, C = _check(inputs, n_k)
    name = instantiation(inputs, f32)
    device = inputs["cp0"].device
    chunk = k_chunk(B, C, n_k)
    if smem_bytes(C, chunk) > SMEM_LIMIT:
        raise ValueError(f"C={C} channels need {smem_bytes(C, chunk)} B of shared memory "
                         f"(> {SMEM_LIMIT})")
    cboc = "cboc_ab" in inputs
    alpha, beta = inputs["cboc_ab"].tolist() if cboc else (0.0, 0.0)
    gain = inputs.get(GAIN_OPERAND)
    if f32:
        out = torch.empty((B, n_k * P_GRID, 2), dtype=torch.float32, device=device)
    else:
        out = torch.empty((B, n_k, P_GRID), dtype=torch.int32, device=device)
    planes = torch.empty(planes_bytes(B, C, n_k), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        err = lib.synth_kp_v5_pair_launch(
            *(inputs[k].data_ptr() for k in PLANE_OPERANDS), inputs["vpack_rs"].data_ptr(),
            inputs["sym_bits"].data_ptr(), inputs["pil_bits"].data_ptr(),
            None if gain is None else gain.data_ptr(), planes.data_ptr(), out.data_ptr(),
            alpha, beta, cboc, f32, B, C, n_k, chunk, T_RS,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, name)
    launch_count += 1
    launch_counts[name] += 1
    launch_counts[PLANES] += 1
    return out


def decode_planes(planes: torch.Tensor, B: int, C: int, n_k: int) -> dict:
    """The planes scratch -> the dict of `kp_planes_ref`, views of it:
    'plf' (B, C, 1300, 4) float32 psi, w8, cos p, sin p; 'chip'
    (B, C, 8, 1300) and 'bits' (B, C, 1300) int32 words; 'cisk'
    (B, C, n_k, 2) float32 cos, sin of the K factor."""
    pad = P_TILES * P_TILE
    words = planes.view(torch.int32)
    n = B * C * pad
    plf = words[:4 * n].view(torch.float32).view(B, C, pad, 4)[:, :, :P_GRID]
    chip = words[4 * n:12 * n].view(B, C, 2, pad, 4).permute(0, 1, 2, 4, 3).reshape(B, C, ROWS, pad)
    bits = words[12 * n:13 * n].view(B, C, pad)[..., :P_GRID]
    cisk = words[13 * n:].view(torch.float32).view(B, C, n_k, 2)
    return {"plf": plf, "chip": chip[..., :P_GRID], "bits": bits, "cisk": cisk}


def kp_planes(inputs: dict, n_k: int) -> dict:
    """The prologue's planes of the prepared operands (`decode_planes`'
    dict): the prologue kernel alone on a GPU, the plain PyTorch version
    (`kp_planes_ref`) on the CPU."""
    device = inputs["cp0"].device
    if device.type == "cpu":
        return kp_planes_ref(inputs, n_k)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib, _ = library()
    B, C = inputs["cp0"].shape
    return decode_planes(_launch_planes(lib, inputs, n_k), B, C, n_k)


def synth_kp_packed(inputs: dict, n_k: int) -> torch.Tensor:
    """(B, n_k, 1300) int32 packed I/Q of the prepared operands
    (ops/synth_kp.prepare_kp_inputs) on their device: the CUDA kernel on
    a GPU, the plain PyTorch version on the CPU."""
    device = inputs["cp0"].device
    if device.type == "cpu":
        return synth_kp_packed_ref(inputs, n_k)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib, _ = library()
    return _launch(lib, inputs, n_k)


def synth_kp_int16(inputs: dict, n_k: int) -> torch.Tensor:
    """(B, 2*n_k*1300) interleaved int16 I/Q (emit="int16"): the packed
    output viewed as int16, on the inputs' device."""
    global int16_launch_count
    out = iq16_view(synth_kp_packed(inputs, n_k))
    if out.device.type == "cuda":
        int16_launch_count += 1
    return out


def synth_kp_accum(inputs: dict, n_k: int) -> torch.Tensor:
    """(B, n_k*1300, 2) float32 `LUT_AMPLITUDE * acc` of the prepared
    operands on their device (emit="f32"): the CUDA kernel on a GPU, the
    plain PyTorch version on the CPU.  Sine-BOC or CBOC; the f32 emit
    takes no per-channel gain."""
    if GAIN_OPERAND in inputs:
        raise ValueError("the f32 emit has no per-channel gain instantiation")
    device = inputs["cp0"].device
    if device.type == "cpu":
        return synth_kp_accum_ref(inputs, n_k)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib, _ = library()
    return _launch(lib, inputs, n_k, f32=True)
