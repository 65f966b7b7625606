"""The port's copies of the JAX package's JAX-free tools against their
originals, on the CPU: the float64 ground truth of the hot loop
(`ops/oracle.py`), the utilities (`utils/`: rinex_dump, sat_pos,
convert_telem, coord_update_cli) and the GNSS-SDR monitoring bridge
(`monitoring/`: client, nav_listener, the protoc-generated messages).
They are the same code, so equality is exact: equal arrays, bytes, text
or datagrams.  The port's direct engine in lut512 mode is held to the
port's oracle under the JAX package's own bound for that pair
(tests/test_hotloop_ref_ab.py:105-119): it builds its tiles in float32,
so it is not exact."""

import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from galileo_sdr_sim_tpu.ops import synth as jsynth
from galileo_sdr_sim_tpu.ops.oracle import synth_epoch_oracle as jax_oracle
from galileo_sdr_sim_tpu.utils import convert_telem as j_convert
from galileo_sdr_sim_tpu.utils import coord_update_cli as j_coord
from galileo_sdr_sim_tpu.utils import rinex_dump as j_dump
from galileo_sdr_sim_tpu.utils import sat_pos as j_satpos
from galileo_sdr_sim_tpu_torch.constants import LUT_AMPLITUDE, NUM_IQ_SAMPLES
from galileo_sdr_sim_tpu_torch.harness import free_udp_ports
from galileo_sdr_sim_tpu_torch.ops.oracle import synth_epoch_oracle
from galileo_sdr_sim_tpu_torch.ops.synth import TILE, prepare_device_inputs, synth_block
from galileo_sdr_sim_tpu_torch.utils import convert_telem, coord_update_cli, rinex_dump, sat_pos

from _torch_parity import CPU, LLH, NAV, START, fixture_batch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def batch():
    return fixture_batch(8)


@pytest.mark.parametrize("e", [0, 7])
def test_oracle_equals_the_jax_oracle(batch, e):
    got = synth_epoch_oracle(batch, e)
    assert got.dtype == np.int16 and got.shape == (2 * NUM_IQ_SAMPLES,)
    assert np.array_equal(got, jax_oracle(batch, e))
    assert np.count_nonzero(got) > 0.9 * got.size


@pytest.fixture(scope="module")
def lut512_block(batch):
    """The port's direct engine in lut512 mode on the block, int32."""
    inputs = prepare_device_inputs(batch, TILE, NUM_IQ_SAMPLES, pad_epochs=8, device=CPU)
    out = synth_block(inputs, tile=TILE, mode="lut512")[:, : 2 * NUM_IQ_SAMPLES]
    return out.numpy().astype(np.int32)


def test_lut512_direct_engine_equals_the_jax_engine(batch, lut512_block):
    inputs = jsynth.prepare_device_inputs(batch, nsamples=NUM_IQ_SAMPLES)
    ref = np.asarray(jsynth.synth_block(inputs, mode="lut512"))[:, : 2 * NUM_IQ_SAMPLES]
    assert np.array_equal(lut512_block, ref)


@pytest.mark.parametrize("e", [0, 3, 7])
def test_lut512_direct_engine_meets_the_oracle_bound(batch, lut512_block, e):
    """>= 99.5% of values identical, complex correlation >= 0.999, and
    no difference above one chip-transition flip (4 * LUT_AMPLITUDE) but
    where two channels flip on one sample: on this scene the JAX
    package's own engine, which the port's equals, has 4 such values in
    the block's 4,160,000 (1358 to 1776; epochs 0, 3 and 6), so those
    are held to two flips and to 2 an epoch."""
    out, ref = lut512_block[e], synth_epoch_oracle(batch, e).astype(np.int32)
    assert (out == ref).mean() >= 0.995
    a, b = out[0::2] + 1j * out[1::2], ref[0::2] + 1j * ref[1::2]
    assert abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999
    diff = np.abs(out - ref)
    assert diff.max() <= 2 * 4 * LUT_AMPLITUDE
    assert np.count_nonzero(diff > 4 * LUT_AMPLITUDE) <= 2


@pytest.mark.parametrize("options", [[], ["--prn", "13"]])
def test_rinex_dump_prints_the_same_text(capsys, options):
    assert rinex_dump.main([str(NAV), *options]) == 0
    got = capsys.readouterr().out
    assert j_dump.main([str(NAV), *options]) == 0
    assert got == capsys.readouterr().out
    assert got.count("records") == (1 if options else got.count("\nE"))
    assert got.startswith("IONO ")


def test_sat_pos_writes_the_same_csv(tmp_path):
    llh = ",".join(str(v) for v in LLH)
    argv = ["-e", str(NAV), "-t", START, "-l", llh, "-d", "1"]
    assert sat_pos.main([*argv, "-o", str(tmp_path / "port.csv")]) == 0
    assert j_satpos.main([*argv, "-o", str(tmp_path / "jax.csv")]) == 0
    got = (tmp_path / "port.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text()
    assert len(got.splitlines()) > 10 * 7  # a row a 0.1 s of each satellite in view


def test_convert_telem_writes_the_same_replay_file(tmp_path):
    """Seeded CSV channels (tow_ms,symbol rows at 4 ms, overlapping TOW
    ranges) -> the same frames of 9 doubles."""
    rng = np.random.default_rng(31)
    channels = []
    for prn, start in ((3, 1000), (5, 1012), (24, 996)):
        tow = start + 4 * np.arange(40)
        sym = rng.choice([-1, 1], tow.size)
        path = tmp_path / f"telem{prn}.csv"
        np.savetxt(path, np.stack([tow, sym], axis=1), delimiter=",", fmt="%d")
        channels.append(f"prn{prn:02d}:{path}")
    assert convert_telem.main([*channels, "--out", str(tmp_path / "port.dat")]) == 0
    assert j_convert.main([*channels, "--out", str(tmp_path / "jax.dat")]) == 0
    got = (tmp_path / "port.dat").read_bytes()
    assert got == (tmp_path / "jax.dat").read_bytes()
    frames = np.frombuffer(got, dtype="<f8").reshape(-1, 9)
    assert len(frames) == len({*range(996, 996 + 160 + 16, 4)}) and frames[0, 8] == 996.0


def _received(sock, n: int) -> list:
    sock.settimeout(5.0)
    return [sock.recvfrom(256)[0] for _ in range(n)]


def test_coord_update_cli_replay_sends_the_same_datagrams(tmp_path, capsys):
    rows = np.array([LLH, (42.5, -71.2, 30.0), (43.0, -70.0, 50.0)])
    np.savetxt(tmp_path / "track.csv", rows, delimiter=",")
    (port,) = free_udp_ports(1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", port))
        sent = []
        for mod in (coord_update_cli, j_coord):
            argv = ["--replay", str(tmp_path / "track.csv"), "--rate", "500", "--port", str(port)]
            assert mod.main(argv) == 0
            sent.append((_received(rx, len(rows)), capsys.readouterr().out))
    assert sent[0] == sent[1]
    assert [np.frombuffer(d, dtype="<f8").tolist() for d in sent[0][0]] == rows.tolist()


# --- the monitoring bridge (needs protobuf, the `monitoring` extra) ----------


def _observables(pb2, entries, tow_ms) -> bytes:
    """A GNSS-SDR Monitor datagram; entries = [(channel_id, prn, nav_symbol)]."""
    obs = pb2.Observables()
    for channel_id, prn, sym in entries:
        ch = obs.observable.add()
        ch.channel_id, ch.prn, ch.nav_symbol = channel_id, prn, sym
        ch.fs, ch.tow_at_current_symbol_ms = 2600000, tow_ms
        ch.cn0_db_hz, ch.carrier_doppler_hz = 45.0, 1000.0
    return obs.SerializeToString()


def _seeded_stream(pb2, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    prns = [11, 24, 33]
    return [_observables(pb2, [(c, p, int(rng.choice([-1, 1]))) for c, p in enumerate(prns)],
                         1000 + 4 * k) for k in range(6)]


def test_monitoring_client_relays_and_records_as_the_jax_client(tmp_path):
    pytest.importorskip("google.protobuf")
    from galileo_sdr_sim_tpu.monitoring import gnss_synchro_pb2 as j_pb2
    from galileo_sdr_sim_tpu.monitoring.client import MonitoringClient as JaxClient
    from galileo_sdr_sim_tpu_torch.monitoring import gnss_synchro_pb2
    from galileo_sdr_sim_tpu_torch.monitoring.client import MonitoringClient

    stream = _seeded_stream(gnss_synchro_pb2)
    assert stream == _seeded_stream(j_pb2)
    relayed = []
    for name, cls in (("port", MonitoringClient), ("jax", JaxClient)):
        listen, relay = free_udp_ports(2)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
            rx.bind(("127.0.0.1", relay))
            client = cls(listen_port=listen, relay_port=relay,
                         record_path=str(tmp_path / f"{name}.dat"), display=False)
            try:
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                    for datagram in stream:
                        tx.sendto(datagram, ("127.0.0.1", listen))
                        assert client.step(timeout=5.0)
            finally:
                client.close()
            relayed.append(_received(rx, len(stream)))
    assert relayed[0] == relayed[1]
    record = (tmp_path / "port.dat").read_bytes()
    assert record == (tmp_path / "jax.dat").read_bytes() == b"".join(relayed[0])
    assert np.frombuffer(record, dtype="<f8").reshape(-1, 9)[:, 8].tolist() == [1000.0 + 4 * k for k in range(6)]


def test_monitoring_client_feeds_the_port_bit_queues():
    """tests/test_monitoring.py's loop, port to port, on free ports: two
    TOW epochs through the client reach the simulator's bit queues."""
    pytest.importorskip("google.protobuf")
    from galileo_sdr_sim_tpu_torch.io.udp import UdpServers
    from galileo_sdr_sim_tpu_torch.monitoring import gnss_synchro_pb2
    from galileo_sdr_sim_tpu_torch.monitoring.client import MonitoringClient

    *ports, listen = free_udp_ports(4)
    servers = UdpServers(np.array(LLH), ports=tuple(ports)).start()
    client = MonitoringClient(listen_port=listen, relay_port=ports[1], record_path=None,
                              display=False)
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(_observables(gnss_synchro_pb2, [(0, 11, 1), (1, 24, -1)], 1000),
                      ("127.0.0.1", listen))
            assert client.step(timeout=5.0)
            tx.sendto(_observables(gnss_synchro_pb2, [(0, 11, -1), (1, 24, -1)], 1004),
                      ("127.0.0.1", listen))
            assert client.step(timeout=5.0)
            tx.sendto(b"\xff\xfe\x01garbage", ("127.0.0.1", listen))
            assert client.step(timeout=5.0) is False
        deadline = time.monotonic() + 5.0
        while len(servers.state.bit_queues.get(11, [])) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert servers.state.pop_bits(11, 4) == [1, -1]
        assert servers.state.pop_bits(24, 4) == [-1, -1]
        assert servers.state.tow_correction == pytest.approx(1.0)
    finally:
        client.close()
        servers.stop()


def test_nav_listener_prints_as_the_jax_listener():
    """`python -m ...monitoring.nav_listener PORT` of both packages, one
    navMsg datagram each: the same text."""
    pytest.importorskip("google.protobuf")
    from galileo_sdr_sim_tpu_torch.monitoring import nav_message_pb2

    msg = nav_message_pb2.navMsg(system="E", signal="1B", prn=11, tow_at_current_symbol_ms=603018000,
                                 nav_message="01" * 60)
    ports = free_udp_ports(2)
    procs = [subprocess.Popen([sys.executable, "-u", "-m", f"{pkg}.monitoring.nav_listener", str(p)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pkg, p in zip(("galileo_sdr_sim_tpu_torch", "galileo_sdr_sim_tpu"), ports)]
    try:
        texts = []
        for proc, port in zip(procs, ports):
            assert "Listening" in proc.stderr.readline()  # bound: the datagram is not lost
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                tx.sendto(msg.SerializeToString(), ("127.0.0.1", port))
            texts.append("".join(proc.stdout.readline() for _ in range(6)))
    finally:
        for proc in procs:
            proc.kill()
            proc.communicate(timeout=30)
    assert texts[0] == texts[1]
    assert "PRN: 11\n" in texts[0] and f"Nav message: {'01' * 60}\n" in texts[0]
