"""Monitoring client: GNSS-SDR Monitor stream -> live table + bit relay.

Behavioural port of the reference monitoring-client (reference:
galileo-gnss-monitoring/monitoring-client/gnss_synchro_udp_source.cc):

* listens on a UDP port for `gnss_sdr.Observables` protobuf datagrams
  (GNSS-SDR's `Monitor.enable_protobuf=true` output, port 1234 in the
  reference configs);
* keeps the latest GnssSynchro per channel (fs != 0 marks validity);
* renders a tracking table (CN0, Doppler, code phase, TOW, pseudorange);
* on every TOW change, forwards one datagram of 9 doubles to the
  simulator's bit port 7531: slots [0..7] = prn*10 + (nav_symbol > 0),
  slot [8] = TOW ms — exactly the reference wire format
  (gnss_synchro_udp_source.cc:107-131), optionally recording to
  rx_bits.dat.

Run: python -m galileo_sdr_sim_tpu.monitoring.client [listen_port]
"""

from __future__ import annotations

import socket
import struct
import sys

from . import gnss_synchro_pb2

MAX_CHAN = 9  # 8 channel slots + TOW (INCOMING_SIZE on the simulator side)


class MonitoringClient:
    def __init__(
        self,
        listen_port: int = 1234,
        relay_host: str = "127.0.0.1",
        relay_port: int = 7531,
        record_path: str | None = "./rx_bits.dat",
        display: bool = True,
    ):
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("0.0.0.0", listen_port))
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.relay_addr = (relay_host, relay_port)
        self.channels: dict[int, gnss_synchro_pb2.GnssSynchro] = {}
        self.old_tow = 0.0
        self.display = display
        self.record = open(record_path, "wb") if record_path else None

    def step(self, timeout: float | None = None) -> bool:
        """Receive one Observables datagram; returns False on parse error."""
        if timeout is not None:
            self.rx.settimeout(timeout)
        try:
            data, _ = self.rx.recvfrom(1500)
        except socket.timeout:
            return True
        stocks = gnss_synchro_pb2.Observables()
        try:
            stocks.ParseFromString(data)
        except Exception:
            return False

        for ch in stocks.observable:
            if ch.fs != 0:  # valid channel
                self.channels[ch.channel_id] = ch

        bits = [0.0] * MAX_CHAN
        new_tow = self.old_tow
        for channel_id, ch in sorted(self.channels.items()):
            main_bit = 1 if ch.nav_symbol > 0 else 0
            if 0 <= channel_id < MAX_CHAN - 1:
                bits[channel_id] = float(ch.prn * 10 + main_bit)
            new_tow = float(ch.tow_at_current_symbol_ms)

        if self.display:
            self._print_table()

        if self.old_tow != new_tow:
            bits[MAX_CHAN - 1] = new_tow
            payload = struct.pack(f"<{MAX_CHAN}d", *bits)
            self.tx.sendto(payload, self.relay_addr)
            if self.record:
                self.record.write(payload)
                self.record.flush()
            self.old_tow = new_tow
        return True

    def _print_table(self) -> None:
        sys.stderr.write("\x1b[2J\x1b[H")
        sys.stderr.write(
            f"{'CH':>3}{'PRN':>6}{'CN0 [dB-Hz]':>14}{'Doppler [Hz]':>17}"
            f"{'Code Phase':>21}{'rx_time':>25}{'TOW_ms':>14}{'Pseudorange':>16}\n"
        )
        for channel_id, ch in sorted(self.channels.items()):
            sys.stderr.write(
                f"{channel_id:3d}{ch.prn:6d}{ch.cn0_db_hz:14f}"
                f"{ch.carrier_doppler_hz:17f}{ch.acq_delay_samples:21f}"
                f"{ch.rx_time:25f}{ch.tow_at_current_symbol_ms:14d}"
                f"{ch.pseudorange_m:16f}\n"
            )

    def run(self) -> None:
        while True:
            self.step()

    def close(self) -> None:
        self.rx.close()
        self.tx.close()
        if self.record:
            self.record.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    port = int(argv[0]) if argv else 1234
    client = MonitoringClient(listen_port=port)
    try:
        client.run()
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
