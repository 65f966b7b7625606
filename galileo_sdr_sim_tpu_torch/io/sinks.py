"""Output sinks for the interleaved int16 I/Q stream.

The reference's transport layer is a pthread ring FIFO drained by a UHD
thread or an fwrite file sink (reference: src/fifo.cpp, src/main.cpp:55-127,
src/galileo-sdr.cpp:542,570-595).  Here sinks are simple writer objects;
rate decoupling/backpressure lives in the streaming executor
(io/stream.py) and, for real-time SDR output, in the native ring buffer
(native/, io/native_fifo.py).

The port's copy adds one span to the original's text: `FileSink.write` is
the span `file` (profiling.span; `sink_write/file` in the streaming
executor, nothing where no Timer is installed).
"""

from __future__ import annotations

import socket
import sys
from pathlib import Path

import numpy as np

from ..profiling import span


class Sink:
    def write(self, iq: np.ndarray) -> None:  # interleaved int16
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileSink(Sink):
    """ishort file sink; '-' = stdout (main.cpp:330-341)."""

    def __init__(self, path: str | Path):
        self._own = str(path) != "-"
        self._fh = open(path, "wb") if self._own else sys.stdout.buffer

    def write(self, iq: np.ndarray) -> None:
        with span("file"):
            self._fh.write(np.ascontiguousarray(iq, dtype=np.int16).tobytes())

    def close(self) -> None:
        if self._own:
            self._fh.close()
        else:
            self._fh.flush()


class UdpSink(Sink):
    """Datagram sink: chunks the stream into <= 32768-sample packets
    (SAMPLES_PER_BUFFER, constants.h:78) for network consumers."""

    def __init__(self, host: str, port: int, samples_per_packet: int = 8192):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._addr = (host, port)
        self._chunk = samples_per_packet * 2  # int16 values per packet

    def write(self, iq: np.ndarray) -> None:
        flat = np.ascontiguousarray(iq, dtype=np.int16).reshape(-1)
        for off in range(0, flat.size, self._chunk):
            self._sock.sendto(flat[off : off + self._chunk].tobytes(), self._addr)

    def close(self) -> None:
        self._sock.close()


class NullSink(Sink):
    """Benchmarking sink."""

    def __init__(self):
        self.samples = 0

    def write(self, iq: np.ndarray) -> None:
        self.samples += iq.size // 2


class UsrpSink(Sink):
    """UHD transmit sink (reference: src/usrp.cpp, main.cpp:55-127).

    Requires the python 'uhd' package (not bundled in this image); raises a
    clear error otherwise.  Streams sc16 at the configured rate/frequency.
    """

    def __init__(
        self,
        samp_rate: float = 2.6e6,
        freq: float = 1575.42e6,
        gain: float = 30.0,
        device_args: str = "",
    ):
        try:
            import uhd  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "USRP output requires the 'uhd' python package (UHD driver). "
                "Install python3-uhd, or disable USRP with -U 1 for the file sink."
            ) from e
        self._uhd = uhd
        usrp = uhd.usrp.MultiUSRP(device_args)
        usrp.set_tx_rate(samp_rate)
        usrp.set_tx_freq(uhd.libpyuhd.types.tune_request(freq))
        usrp.set_tx_gain(gain)
        st_args = uhd.usrp.StreamArgs("sc16", "sc16")
        self._stream = usrp.get_tx_stream(st_args)
        self._md = uhd.types.TXMetadata()
        self._md.start_of_burst = True
        self._md.end_of_burst = False

    def write(self, iq: np.ndarray) -> None:
        # sc16 cpu format: samples are interleaved int16 I/Q pairs.
        flat = np.ascontiguousarray(iq, dtype=np.int16).reshape(1, -1)
        self._stream.send(flat, self._md)
        self._md.start_of_burst = False

    def close(self) -> None:
        self._md.end_of_burst = True
