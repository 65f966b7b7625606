"""Convert GNSS-SDR telemetry dumps to a bit-relay replay file.

Counterpart of the reference's utils/convert_telem.py: reads per-channel
GNSS-SDR telemetry-decoder dumps (.mat with `nav_symbol` and
`tow_at_current_symbol_ms`, or CSV `tow_ms,symbol` rows), merges channels
by TOW, and writes the packed replay format consumed by the simulator's
bit port: per TOW step, 8 doubles of `prn*10 + bit` followed by one TOW
double (little-endian) — the same frames the live monitoring client sends
to UDP 7531.

  python -m galileo_sdr_sim_tpu.utils.convert_telem \
      --out replay.dat prn03:telem3.mat prn05:telem5.mat

The replay file can then be streamed with --send at the wanted rate.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys
import time

import numpy as np

SLOTS = 8


def load_channel(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (tow_ms, symbol in {0,1}) arrays."""
    if path.endswith(".mat"):
        from scipy.io import loadmat

        m = loadmat(path)
        tow = np.asarray(m["tow_at_current_symbol_ms"]).reshape(-1)
        sym = np.asarray(m["nav_symbol"]).reshape(-1)
    else:
        arr = np.loadtxt(path, delimiter=",")
        tow, sym = arr[:, 0], arr[:, 1]
    return tow.astype(np.float64), (sym > 0).astype(np.int64)


def convert(channel_files: dict[int, str], out_path: str) -> int:
    streams = {prn: load_channel(p) for prn, p in channel_files.items()}
    all_tows = sorted(set(np.concatenate([t for t, _ in streams.values()]).tolist()))
    nframes = 0
    with open(out_path, "wb") as fh:
        for tow in all_tows:
            frame = [0.0] * (SLOTS + 1)
            slot = 0
            for prn, (t, s) in streams.items():
                idx = np.searchsorted(t, tow)
                if idx < len(t) and t[idx] == tow and slot < SLOTS:
                    frame[slot] = float(prn * 10 + int(s[idx]))
                    slot += 1
            if slot == 0:
                continue
            frame[SLOTS] = float(tow)
            fh.write(struct.pack(f"<{SLOTS + 1}d", *frame))
            nframes += 1
    return nframes


def send(path: str, host: str, port: int, rate: float) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    frame_size = (SLOTS + 1) * 8
    data = open(path, "rb").read()
    for off in range(0, len(data) - frame_size + 1, frame_size):
        sock.sendto(data[off : off + frame_size], (host, port))
        time.sleep(1.0 / rate)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("channels", nargs="*",
                   help="prnNN:path entries, e.g. prn03:telem3.mat")
    p.add_argument("--out", default="replay.dat")
    p.add_argument("--send", metavar="FILE", help="stream an existing replay file")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7531)
    p.add_argument("--rate", type=float, default=250.0, help="frames/s")
    args = p.parse_args(argv)

    if args.send:
        send(args.send, args.host, args.port, args.rate)
        return 0

    files = {}
    for entry in args.channels:
        tag, path = entry.split(":", 1)
        files[int(tag.removeprefix("prn"))] = path
    if not files:
        p.error("no channel files given")
    n = convert(files, args.out)
    print(f"wrote {n} frames to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
