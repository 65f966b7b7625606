"""ctypes bindings for the native I/Q ring buffer (native/iqring.cpp).

The native ring is the real-time transport: a C++ SPSC ring buffer with a
background consumer thread (file/UDP), replacing the reference's pthread
FIFO + tx_task pair (reference: src/fifo.cpp, src/main.cpp:55-127).  The
producer side (`NativeFifoSink.write`) applies backpressure exactly like
the reference's fifo_write_ready wait when the consumer falls behind.

The shared library is built on first use with g++ (no pip deps) from the
checkout's native/iqring.cpp, which it only reads, into the port's
kernel build directory (ops/_build.py), keyed on a hash of the source
and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..constants import FIFO_LENGTH, SAMPLES_PER_BUFFER
from ..ops import _build
from .sinks import Sink

_SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "iqring.cpp"
_CXXFLAGS = ("-O2", "-Wall", "-shared", "-fPIC", "-pthread", "-std=c++17")  # native/Makefile's
_build_lock = threading.Lock()
_lib = None


def _build_library() -> Path:
    if not _SOURCE.is_file():
        raise RuntimeError(
            f"native iqring source not found at {_SOURCE}: the ring is "
            "built from a source checkout's native/ directory"
        )
    digest = hashlib.sha256(_SOURCE.read_bytes() + "\0".join(_CXXFLAGS).encode()).hexdigest()
    out = _build.BUILD_DIR / f"libiqring_{digest[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *_CXXFLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {_SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        lib = ctypes.CDLL(str(_build_library()))
        lib.iqring_create.restype = ctypes.c_void_p
        lib.iqring_create.argtypes = [ctypes.c_size_t]
        lib.iqring_destroy.argtypes = [ctypes.c_void_p]
        lib.iqring_write.restype = ctypes.c_size_t
        lib.iqring_write.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ]
        lib.iqring_read.restype = ctypes.c_size_t
        lib.iqring_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ]
        lib.iqring_close.argtypes = [ctypes.c_void_p]
        lib.iqring_available.restype = ctypes.c_size_t
        lib.iqring_available.argtypes = [ctypes.c_void_p]
        lib.iqring_free_space.restype = ctypes.c_size_t
        lib.iqring_free_space.argtypes = [ctypes.c_void_p]
        lib.iqring_start_file_consumer.restype = ctypes.c_int
        lib.iqring_start_file_consumer.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.iqring_start_udp_consumer.restype = ctypes.c_int
        lib.iqring_start_udp_consumer.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t,
        ]
        lib.iqring_stop.argtypes = [ctypes.c_void_p]
        lib.iqring_consumed.restype = ctypes.c_uint64
        lib.iqring_consumed.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class IqRing:
    """Thin object wrapper over the C ring."""

    def __init__(self, capacity_samples: int = FIFO_LENGTH):
        self._lib = _load()
        self._ptr = self._lib.iqring_create(capacity_samples)
        if not self._ptr:
            raise MemoryError("iqring_create failed")

    def write(self, iq: np.ndarray) -> int:
        flat = np.ascontiguousarray(iq, dtype=np.int16).reshape(-1)
        assert flat.size % 2 == 0
        ptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        return self._lib.iqring_write(self._ptr, ptr, flat.size // 2)

    def read(self, max_samples: int) -> np.ndarray:
        out = np.empty(max_samples * 2, dtype=np.int16)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        n = self._lib.iqring_read(self._ptr, ptr, max_samples)
        return out[: n * 2]

    def start_file_consumer(self, path: str,
                            chunk: int = SAMPLES_PER_BUFFER) -> None:
        rc = self._lib.iqring_start_file_consumer(
            self._ptr, str(path).encode(), chunk
        )
        if rc != 0:
            raise OSError(f"cannot open consumer file {path}")

    def start_udp_consumer(self, host: str, port: int,
                           chunk: int = 8192) -> None:
        rc = self._lib.iqring_start_udp_consumer(
            self._ptr, host.encode(), port, chunk
        )
        if rc != 0:
            raise OSError("cannot open consumer socket")

    @property
    def available(self) -> int:
        return self._lib.iqring_available(self._ptr)

    @property
    def free_space(self) -> int:
        return self._lib.iqring_free_space(self._ptr)

    @property
    def consumed(self) -> int:
        return self._lib.iqring_consumed(self._ptr)

    def close_write(self) -> None:
        """Signal EOF to readers without destroying the ring."""
        self._lib.iqring_close(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.iqring_stop(self._ptr)
            self._lib.iqring_destroy(self._ptr)
            self._ptr = None


class NativeFifoSink(Sink):
    """Sink backed by the native ring + file consumer thread."""

    def __init__(self, path: str, capacity_samples: int = FIFO_LENGTH):
        self.ring = IqRing(capacity_samples)
        self.ring.start_file_consumer(path)

    def write(self, iq: np.ndarray) -> None:
        self.ring.write(iq)  # blocks when the consumer falls behind

    def close(self) -> None:
        self.ring.close()


class ThreadedRingSink(Sink):
    """Native ring + Python consumer thread draining into any Sink.

    The real-time transport for consumers that live in Python (UsrpSink):
    the producer (device drain) writes bursts into the C++ ring with
    reference-style backpressure, while a dedicated thread feeds the
    inner sink in steady SAMPLES_PER_BUFFER chunks — the exact
    producer/consumer split of the reference (galileo_task writes the
    FIFO, tx_task drains 32768-sample buffers into uhd send,
    src/main.cpp:55-127, src/fifo.cpp).
    """

    def __init__(
        self,
        inner: Sink,
        capacity_samples: int = FIFO_LENGTH,
        chunk_samples: int = SAMPLES_PER_BUFFER,
    ):
        self.inner = inner
        self.ring = IqRing(capacity_samples)
        self._chunk = chunk_samples
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def _consume(self) -> None:
        while True:
            buf = self.ring.read(self._chunk)  # blocks; b'' only at EOF
            if buf.size == 0:
                break
            self.inner.write(buf)

    def write(self, iq: np.ndarray) -> None:
        self.ring.write(iq)  # blocks when the inner sink falls behind

    def close(self) -> None:
        self.ring.close_write()  # EOF: consumer drains, then exits
        self._thread.join()
        self.ring.close()
        self.inner.close()
