"""The in-tile gather probe: a hand-written CUDA gather (csrc/gather_probe.cu)
held to its plain version.

It replaces the Pallas TPU kernel `main.probe.k` of
tools/probe_pallas_gather.py, which asks whether an in-kernel
`take_along_axis` lowers on the TPU.  `take_along_axis` launches the
kernel for CUDA tensors and runs its plain version (`torch.take_along_dim`)
for CPU tensors only; on a CUDA tensor it launches or raises.  An index
outside [0, n), n the table's length along `axis`, gives 0 on both (the
kernel never reads outside the table); the probe draws none.  `probe`
draws one seeded table and index set and compares the two with
`torch.equal`; `main` runs the tool's seven probes:

    python -m galileo_sdr_sim_tpu_torch.ops.gather_probe [--device cpu]

and exits non-zero unless every probe prints CORRECT.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from . import _build

SOURCE = "gather_probe"
REPLACES = "tools/probe_pallas_gather.py:23"
# the tool's probes (tools/probe_pallas_gather.py:46-52): shape, maxidx, axis
PROBES = (
    ((8, 128), 128, 1),
    ((16, 128), 128, 1),
    ((8, 256), 256, 1),
    ((16, 512), 512, 1),
    ((16, 8192), 128, 1),
    ((16, 8192), 8192, 1),
    ((128, 128), 128, 0),
)
SEED = 0  # of the generator `main` draws every probe's inputs from

# launches of the kernel in this process (read and reset by chip_smoke.py)
launch_count = 0

_lib: tuple[ctypes.CDLL, _build.Built] | None = None


def library() -> tuple[ctypes.CDLL, _build.Built]:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        built = _build.build(SOURCE)
        lib = _build.load(built)
        lib.gather_probe_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.gather_probe_launch.restype = ctypes.c_int
        lib.gather_probe_error_string.argtypes = [ctypes.c_int]
        lib.gather_probe_error_string.restype = ctypes.c_char_p
        _lib = (lib, built)
    return _lib


def take_along_axis_ref(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain version: torch.take_along_dim, and 0 where an index lies
    outside [0, n), as the kernel gives."""
    inside = (idx >= 0) & (idx < tab.shape[axis])
    out = torch.take_along_dim(tab, torch.where(inside, idx, 0).long(), dim=axis)
    return torch.where(inside, out, 0)


def _check(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"tab and idx must be int32, got {tab.dtype} and {idx.dtype}")
    if tab.dim() != 2 or tab.shape != idx.shape:
        raise ValueError(f"tab and idx must be 2-D of one shape, got {tuple(tab.shape)} "
                         f"and {tuple(idx.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if tab.device != idx.device:
        raise ValueError(f"tab on {tab.device}, idx on {idx.device}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")


def take_along_axis(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """out[r, c] = tab[idx[r, c], c] (axis 0) or tab[r, idx[r, c]] (axis 1),
    int32, on the inputs' device: the CUDA kernel on a GPU, the plain
    version on the CPU.  An index outside [0, n) gives 0."""
    global launch_count
    _check(tab, idx, axis)
    if tab.device.type == "cpu":
        return take_along_axis_ref(tab, idx, axis)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    lib, _ = library()
    out = torch.empty_like(tab)
    rows, cols = tab.shape
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.gather_probe_launch(tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                      rows, cols, axis, stream)
    if err != 0:
        msg = lib.gather_probe_error_string(err).decode()
        raise RuntimeError(f"gather_probe launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return out


def probe_inputs(shape: tuple, maxidx: int, generator: torch.Generator) -> tuple:
    """(tab, idx) on the CPU as the tool draws them: tab in [-3, 4), idx
    in [0, maxidx), int32, from the seeded `generator`."""
    tab = torch.randint(-3, 4, shape, generator=generator, dtype=torch.int32)
    idx = torch.randint(0, maxidx, shape, generator=generator, dtype=torch.int32)
    return tab, idx


def probe(shape: tuple, maxidx: int, axis: int, generator: torch.Generator,
          device: torch.device) -> bool:
    """One probe: the gather on `device` against the plain version on the
    CPU, on the same seeded inputs; prints one line in the tool's words."""
    tab, idx = probe_inputs(shape, maxidx, generator)
    out = take_along_axis(tab.to(device), idx.to(device), axis).cpu()
    ok = torch.equal(out, take_along_axis_ref(tab, idx, axis))
    print(f"{shape} axis={axis} maxidx={maxidx}: {'CORRECT' if ok else 'WRONG RESULT'}")
    return ok


def main(argv=None) -> int:
    from ..device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a GPU) or 'cpu' (the plain version)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"torch {torch.__version__}, device {device} ({name})")
    generator = torch.Generator().manual_seed(SEED)
    results = [probe(shape, maxidx, axis, generator, device) for shape, maxidx, axis in PROBES]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
