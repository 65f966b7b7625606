"""GNSS-SDR monitoring bridge.

Wire-compatible replacement for the reference's monitoring-client /
nav_listener side binaries (reference: galileo-gnss-monitoring/): receives
the GNSS-SDR `Monitor` protobuf stream, renders a live tracking table,
and relays decoded navigation symbols to the simulator's UDP 7531 bit
port — the closed-loop "live I/NAV relay" spoofing mode.

The .proto files under proto/ are the GNSS-SDR project's public interface
definitions (BSD-3-Clause, Carles Fernandez-Prades / CTTC), vendored
verbatim for wire compatibility; *_pb2.py are protoc-generated.
"""
