"""UDP side-channel servers, wire-compatible with the reference tooling.

Reference (include/socket.h) listens on three UDP ports:

* 7533 — live receiver position: 3 little-endian float64 (lat, lon, hgt
  deg/deg/m), fed by utils/coord_update_cli.py (socket.h:165-180).
* 7531 — live navigation-bit relay: 9 float64 per datagram; the first 8
  encode `prn*10 + bit` per channel, the 9th is a one-shot TOW correction
  in ms (socket.h:84-150, fed by the GNSS-SDR monitoring bridge).
* 7532 — dynamic range-rate correction: 1 float64 (socket.h:152-163;
  unused by the reference generator, retained for compatibility).

These run as daemon threads updating thread-safe state the scenario
engine samples once per epoch — the same benign-latest-value semantics as
the reference's unsynchronized globals, but with a lock.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque

import numpy as np

LOCATION_PORT = 7533
BITSTREAM_PORT = 7531
DT_PORT = 7532
INCOMING_SIZE = 9  # doubles per bit-relay datagram (socket.h:10)


class LiveState:
    """Latest-value state shared between UDP threads and the engine."""

    def __init__(self, llh_init: np.ndarray):
        self._lock = threading.Lock()
        self._llh = np.asarray(llh_init, dtype=np.float64).copy()
        self._dt = 0.0
        self.tow_correction: float | None = None
        self.bit_queues: dict[int, deque[int]] = {}  # prn -> symbols (+-1/0)

    @property
    def llh(self) -> np.ndarray:
        with self._lock:
            return self._llh.copy()

    def set_llh(self, llh) -> None:
        with self._lock:
            self._llh = np.asarray(llh, dtype=np.float64).copy()

    @property
    def dynamic_dt(self) -> float:
        with self._lock:
            return self._dt

    def set_dt(self, v: float) -> None:
        with self._lock:
            self._dt = v

    def push_bits(self, prn: int, bit: int) -> None:
        with self._lock:
            q = self.bit_queues.setdefault(prn, deque(maxlen=4096))
            # reference maps wire bit 1 -> +1, 0 -> -1, other -> 0
            q.append(1 if bit == 1 else (-1 if bit == 0 else 0))

    def pop_bits(self, prn: int, n: int) -> list[int]:
        with self._lock:
            q = self.bit_queues.get(prn)
            if not q:
                return []
            return [q.popleft() for _ in range(min(n, len(q)))]


def _serve(port: int, handler, state: LiveState, stop: threading.Event) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("0.0.0.0", port))
    sock.settimeout(0.5)
    while not stop.is_set():
        try:
            data, _ = sock.recvfrom(8192)
        except socket.timeout:
            continue
        except OSError:
            break
        handler(state, data)
    sock.close()


def _on_location(state: LiveState, data: bytes) -> None:
    if len(data) >= 24:
        lat, lon, hgt = struct.unpack("<3d", data[:24])
        state.set_llh([lat, lon, hgt])


def _on_bits(state: LiveState, data: bytes) -> None:
    n = min(len(data) // 8, INCOMING_SIZE)
    vals = struct.unpack(f"<{n}d", data[: 8 * n])
    for v in vals[: INCOMING_SIZE - 1]:
        content = int(v)
        state.push_bits(content // 10, content % 10)
    if n == INCOMING_SIZE and state.tow_correction is None:
        state.tow_correction = vals[-1] / 1000.0  # one-shot (socket.h:140-147)


def _on_dt(state: LiveState, data: bytes) -> None:
    if len(data) >= 8:
        state.set_dt(struct.unpack("<d", data[:8])[0])


class UdpServers:
    """Spawns the three listeners as daemon threads."""

    def __init__(self, llh_init, ports=(LOCATION_PORT, BITSTREAM_PORT, DT_PORT)):
        self.state = LiveState(llh_init)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=_serve, args=(ports[0], _on_location, self.state, self._stop),
                daemon=True, name="locations_thread",
            ),
            threading.Thread(
                target=_serve, args=(ports[1], _on_bits, self.state, self._stop),
                daemon=True, name="bitstreamer_thread",
            ),
            threading.Thread(
                target=_serve, args=(ports[2], _on_dt, self.state, self._stop),
                daemon=True, name="dt_thread",
            ),
        ]

    def start(self) -> "UdpServers":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
