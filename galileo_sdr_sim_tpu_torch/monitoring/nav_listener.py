"""Navigation-message listener: prints GNSS-SDR `navMsg` protobuf frames.

Debugging aid for the relay mode, mirroring the reference nav_listener
(reference: galileo-gnss-monitoring/nav_listener/nav_msg_udp_listener.cc):
GNSS-SDR's NavDataMonitor streams decoded I/NAV half pages (120 bits) over
UDP; this prints system/signal/PRN/TOW and the page bits.

Run: python -m galileo_sdr_sim_tpu.monitoring.nav_listener [port]
"""

from __future__ import annotations

import socket
import sys

from . import nav_message_pb2


def listen(port: int = 1237, out=sys.stdout) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("0.0.0.0", port))
    print(f"Listening for nav messages on UDP {port}", file=sys.stderr)
    while True:
        data, _ = sock.recvfrom(4096)
        msg = nav_message_pb2.navMsg()
        try:
            msg.ParseFromString(data)
        except Exception:
            continue
        print(
            f"New Data received:\n"
            f"System: {msg.system}\n"
            f"Signal: {msg.signal}\n"
            f"PRN: {msg.prn}\n"
            f"TOW of last symbol [ms]: {msg.tow_at_current_symbol_ms}\n"
            f"Nav message: {msg.nav_message}\n",
            file=out,
        )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    listen(int(argv[0]) if argv else 1237)
    return 0


if __name__ == "__main__":
    sys.exit(main())
