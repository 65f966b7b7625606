"""Measurements of the port's kernels on the card: device time with CUDA
events, the launch floor (an empty kernel of the same grid and block
size, csrc/launch_floor.cu, timed the same way), and what the compiler
made of a kernel library (its SASS instruction classes, from
`cuobjdump -sass`, and its registers and spills, from `ptxas -v`).  Used
by chip_smoke.py and ops/kp_ab.py; the timing needs a GPU, the SASS needs
the CUDA toolkit's `cuobjdump`.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import _build
from ._build import find_nvcc

# ~5 ms of an H100's clock: longer than the host takes to queue ten calls
# of a kernel wrapper (see median_ms)
HOLD_CYCLES = 10_000_000

# instruction classes counted in the SASS: the conversions (I2F, F2I and
# their sm_90 forms I2FP, F2IP, the float rounding FRND, F2F), the FP32
# pipe, integer logic, shifts and byte permutes, shared and global memory
SASS_CLASSES = (
    "I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "FFMA", "FADD", "FMUL", "FSEL", "FSETP",
    "LOP3", "PRMT", "SHF", "IMAD", "IADD3", "ISETP", "SEL", "LDS", "LDG", "STS", "STG", "MUFU",
)
CONVERSIONS = ("I2F", "I2FP", "F2I", "F2IP", "F2F")

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")

_floor_lib: tuple[ctypes.CDLL, _build.Built] | None = None


def median_ms(fn, n: int = 25, per: int = 10, warmup: int = 3) -> float:
    """Median over n samples of the device time of one call, each sample
    `per` back-to-back calls between two CUDA events, divided by `per`.
    A sleep kernel of HOLD_CYCLES runs ahead of the first event, so the
    host queues all `per` calls before the card reaches them: a call
    whose device time is below its host-side launch cost (a few tens of
    microseconds through a wrapper) is then timed on the card, not on
    the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        for _ in range(per):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per)
    return float(np.median(times))


def host_ms(fn, per: int = 10, n: int = 25) -> float:
    """Host time of one call to queue `fn` (no synchronize inside): the
    median over n samples of the mean over `per` back-to-back calls, what
    a wrapper call costs the host."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        times.append((time.perf_counter() - t0) / per * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def floor_library() -> tuple[ctypes.CDLL, _build.Built]:
    """Build (at first use) and load csrc/launch_floor.cu, the empty
    kernel."""
    global _floor_lib
    if _floor_lib is None:
        built = _build.build("launch_floor")
        lib = _build.load(built)
        lib.launch_floor_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.launch_floor_launch.restype = ctypes.c_int
        _floor_lib = (lib, built)
    return _floor_lib


def floor_ms(launches) -> float:
    """The launch floor of a kernel call: `median_ms` of empty kernels
    launched back to back on the current stream of the current device, one for each
    ((gx, gy, gz), threads) of `launches` (a wrapper's `launch_geometry`):
    what launches of these grids and block sizes take on the card when
    the kernels do nothing."""
    lib, _ = floor_library()

    def run() -> None:
        stream = torch.cuda.current_stream().cuda_stream
        for grid, threads in launches:
            err = lib.launch_floor_launch(*grid, threads, stream)
            if err != 0:
                raise RuntimeError(f"empty kernel {grid} x {threads}: CUDA error {err}")

    return median_ms(run)


def parse_sass(text: str) -> dict:
    """`cuobjdump -sass` output -> {function (mangled): [(address, opcode,
    instruction)]}, the opcode without its modifiers or predicate."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            body = _PRED.sub("", m.group(2))
            cur.append((int(m.group(1), 16), body.split(" ", 1)[0].split(".", 1)[0], body))
    return funcs


def _count(insns) -> dict:
    counts = dict.fromkeys(SASS_CLASSES, 0)
    for _, op, _ in insns:
        if op in counts:
            counts[op] += 1
    counts["total"] = len(insns)
    return counts


def main_loop(insns) -> list:
    """The instructions of the innermost loop with the most FFMA: the
    span from a backward branch's target to the branch, holding no
    other backward branch.  [] when the function has no loop."""
    loops = []
    for addr, op, body in insns:
        m = _TARGET.search(body) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    best = []
    for a, b in inner:
        span = [i for i in insns if a <= i[0] <= b]
        if sum(op == "FFMA" for _, op, _ in span) > sum(op == "FFMA" for _, op, _ in best):
            best = span
    return best


def sass_counts(lib: Path) -> dict:
    """{function (mangled): {"kernel": class counts of the whole
    function, "loop": class counts of its main loop (`main_loop`)}} of a
    built kernel library."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {name: {"kernel": _count(insns), "loop": _count(main_loop(insns))}
            for name, insns in parse_sass(text).items()}


def ptxas_summary(log: str) -> dict:
    """`ptxas -v` output -> {function (mangled): "N registers, S B spill
    stores, L B spill loads"}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {})["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return {name: f"{v.get('registers')} registers, {v.get('spills', (0, 0))[0]} B spill "
                  f"stores, {v.get('spills', (0, 0))[1]} B spill loads"
            for name, v in out.items()}


def kp_function(mangled: str) -> str:
    """The kernel name of a mangled symbol of csrc/synth_kp_v5.cu: the
    instantiation of `synth_kp_v5_kernel<CBOC, GAIN, F32>`, or
    synth_kp_v5_planes for the prologue kernel; else the symbol."""
    if "kp_planes_kernel" in mangled:
        return "synth_kp_v5_planes"
    m = re.search(r"synth_kp_v5_kernelILb([01])ELb([01])ELb([01])E", mangled)
    if not m:
        return mangled
    cboc, gain, f32 = (g == "1" for g in m.groups())
    return "synth_kp_v5" + "_cboc" * cboc + "_gain" * gain + "_f32" * f32
