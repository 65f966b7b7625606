"""Wrapper of the hand-written CUDA kernel csrc/synth_kp_v5.cu.

It replaces the Pallas TPU kernel `_kernel_v5`
(galileo_sdr_sim_tpu/ops/synth_kp_pallas.py, sine-BOC, emit="i32pack",
no gain): per block of B epochs it writes (B, n_k, 1300) int32 packed
I/Q.  On an H100 one B=8 block is ~8.3 MB of int32 output against ~0.5
GFLOP of float32 work at C = 8 channels, so the kernel is bound by FP32
arithmetic, not by memory; see the source for its design.

`synth_kp_packed` launches the kernel for CUDA tensors and runs the plain
PyTorch version (ops/synth_kp.synth_kp_packed_ref) for CPU tensors only.
On a CUDA tensor it launches or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .synth_kp import (
    INT_OPERANDS, P_GRID, ROWS, SCALAR_OPERANDS, SYM_BITS, T_RS, W_RS, synth_kp_packed_ref,
)

SOURCE = "synth_kp_v5"
REPLACES = "galileo_sdr_sim_tpu/ops/synth_kp_pallas.py:74 (_kernel_v5)"
# FMA contraction of a*b + c (nvcc -fmad): kept on, the build that lies
# closer to the JAX engine on the fixture scene, whose XLA lowering fuses
# the p-phase multiply-adds too (PERF.md, FMA-contraction finding)
FMAD = True
K_CHUNK = 40  # K rows per block: 5 blocks along K at n_k = 200
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

# launches of the kernel in this process (read and reset by chip_smoke.py)
launch_count = 0

_libs: dict[bool, tuple[ctypes.CDLL, _build.Built]] = {}


def library(fmad: bool = FMAD) -> tuple[ctypes.CDLL, _build.Built]:
    """Build (at first use) and load the kernel library."""
    if fmad not in _libs:
        built = _build.build(SOURCE, (f"-fmad={'true' if fmad else 'false'}",))
        lib = _build.load(built)
        lib.synth_kp_v5_launch.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        lib.synth_kp_v5_launch.restype = ctypes.c_int
        lib.synth_kp_v5_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.synth_kp_v5_smem_bytes.restype = ctypes.c_size_t
        lib.synth_kp_v5_error_string.argtypes = [ctypes.c_int]
        lib.synth_kp_v5_error_string.restype = ctypes.c_char_p
        _libs[fmad] = (lib, built)
    return _libs[fmad]


def _check(inputs: dict, n_k: int) -> tuple[int, int]:
    cp0 = inputs["cp0"]
    if cp0.dim() != 2:
        raise ValueError(f"cp0 must be (B, C), got {tuple(cp0.shape)}")
    B, C = cp0.shape
    for name in SCALAR_OPERANDS:
        t = inputs[name]
        want = torch.int32 if name in INT_OPERANDS else torch.float32
        if t.dtype != want or tuple(t.shape) != (B, C):
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, want {want}({B}, {C})")
        if t.device != cp0.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {cp0.device}")
    tab = inputs["vpack_rs"]
    if tab.dtype != torch.int8 or tuple(tab.shape) != (C, W_RS, T_RS):
        raise ValueError(f"vpack_rs: {tab.dtype}{tuple(tab.shape)}, want int8({C}, {W_RS}, {T_RS})")
    if tab.device != cp0.device or not tab.is_contiguous():
        raise ValueError(f"vpack_rs must be contiguous on {cp0.device}")
    if n_k <= 0 or n_k % ROWS != 0 or n_k // ROWS + 2 > SYM_BITS:
        raise ValueError(f"n_k={n_k}: need a positive multiple of {ROWS} with n_k/8 + 2 <= 32")
    return B, C


def _launch(lib: ctypes.CDLL, inputs: dict, n_k: int) -> torch.Tensor:
    """Launch the kernel of `lib` on the current stream of the inputs'
    device; the output is allocated here, nothing is synchronized."""
    global launch_count
    B, C = _check(inputs, n_k)
    device = inputs["cp0"].device
    k_chunk = min(n_k, K_CHUNK)
    smem = lib.synth_kp_v5_smem_bytes(C, k_chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"C={C} channels need {smem} B of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((B, n_k, P_GRID), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [inputs[name].data_ptr() for name in SCALAR_OPERANDS]
        err = lib.synth_kp_v5_launch(
            *ptrs, inputs["vpack_rs"].data_ptr(), out.data_ptr(),
            B, C, n_k, T_RS, k_chunk, stream,
        )
    if err != 0:
        msg = lib.synth_kp_v5_error_string(err).decode()
        raise RuntimeError(f"synth_kp_v5 launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return out


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
