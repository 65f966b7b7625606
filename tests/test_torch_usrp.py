"""The real-time transmit path on the CPU: the port's CLI without -U
streams through ThreadedRingSink(UsrpSink(...)) as the JAX CLI does
(galileo_sdr_sim_tpu/cli.py:349-357), into the stand-in `uhd` of the
harness (`harness.stand_in_uhd`, put in sys.modules by each test).

Exact equality throughout (the same samples, the same SHA-256): under
`--mode lut512` every block goes through the direct engine, whose
integer carrier table leaves no float rounding in the output, so the
port's radio gets the bytes the JAX CLI's radio gets; on the default
engine the port's radio gets the bytes of the port's own -U 1 file.
The stand-in's DAC clock is held to its own definition on a hand-fed
ring: a producer that stalls past the ring's slack gives exactly one
underrun a stall, one that keeps up gives none; a send that comes late
while the ring held its chunk is a late send, not an underrun."""

import hashlib
import sys
import threading
import time

import numpy as np
import pytest

from galileo_sdr_sim_tpu.cli import main as jax_main
from galileo_sdr_sim_tpu_torch import cli, harness
from galileo_sdr_sim_tpu_torch.constants import FIFO_LENGTH, NUM_IQ_SAMPLES, SAMPLES_PER_BUFFER
from galileo_sdr_sim_tpu_torch.io.native_fifo import IqRing

from _torch_parity import LLH, NAV, START

GAIN, DEVICE_ARGS = "17.5", "type=stub,serial=T1"


def _argv(tmp_path, duration: float, *options) -> list:
    """A USRP command line (no -U, no bit relay) of the fixture scene with
    a one-row user-motion file, which keeps off the fixed UDP ports."""
    static = tmp_path / "static.csv"
    static.write_text(",".join(str(v) for v in LLH) + "\n")
    return ["-e", str(NAV), "-b", "1", "-d", str(duration), "-t", START, "-u", str(static),
            "-G", GAIN, "-a", DEVICE_ARGS, *options]


@pytest.fixture
def uhd(monkeypatch):
    module = harness.stand_in_uhd()
    monkeypatch.setitem(sys.modules, "uhd", module)
    return module


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """The port CLI's USRP run and its -U 1 file run, 0.5 s on the
    default engine (--device cpu) -> (the StandInUsrp, the file's bytes)."""
    tmp = tmp_path_factory.mktemp("usrp")
    module = harness.stand_in_uhd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "uhd", module)
        assert cli.main(_argv(tmp, 0.5, "--device", "cpu")) == 0
    out = tmp / "file.ishort"
    assert cli.main(_argv(tmp, 0.5, "--device", "cpu", "-U", "1", "-o", str(out))) == 0
    (radio,) = module.radios
    return radio, out.read_bytes()


def test_usrp_stream_equals_the_port_file_sink(default_run):
    radio, file_bytes = default_run
    assert radio.stream.samples == len(file_bytes) // 4 == 4 * NUM_IQ_SAMPLES
    assert radio.stream.digest.hexdigest() == hashlib.sha256(file_bytes).hexdigest()


def test_gain_and_device_args_reach_the_radio(default_run):
    radio, _ = default_run
    assert radio.device_args == DEVICE_ARGS
    assert (radio.rate, radio.freq, radio.gain) == (2.6e6, 1575.42e6, float(GAIN))
    assert (radio.stream_args.cpu_format, radio.stream_args.otw_format) == ("sc16", "sc16")


def test_burst_flags(default_run):
    """start_of_burst on the first send only; close marks end_of_burst on
    the metadata and sends no packet of its own (io/sinks.py:117-118, the
    JAX package's behaviour)."""
    radio, _ = default_run
    tx = radio.stream
    assert len(tx.bursts) >= -(-tx.samples // SAMPLES_PER_BUFFER) > 1
    assert tx.bursts[0] and not any(tx.bursts[1:])
    assert tx.md.end_of_burst


def test_usrp_stream_lut512_is_byte_identical_to_the_jax_cli(tmp_path, uhd, monkeypatch):
    """Both CLIs, the same command line, --mode lut512 (every block
    through the direct engine) at --block-epochs 4: the radio gets the
    same samples, the same SHA-256."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    argv = _argv(tmp_path, 1.2, "--mode", "lut512", "--block-epochs", "4")
    assert cli.main([*argv, "--device", "cpu"]) == 0
    assert jax_main(argv) == 0
    port, ref = (r.stream for r in uhd.radios)
    assert port.samples == ref.samples == 11 * NUM_IQ_SAMPLES
    assert port.digest.hexdigest() == ref.digest.hexdigest()
    assert [r.device_args for r in uhd.radios] == [DEVICE_ARGS] * 2


def test_without_uhd_the_run_fails_as_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "uhd", None)  # `import uhd` raises ImportError
    argv = _argv(tmp_path, 0.3)
    with pytest.raises(RuntimeError) as port:
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(RuntimeError) as ref:
        jax_main(argv)
    assert str(port.value) == str(ref.value)
    assert "'uhd' python package" in str(port.value)


def test_paced_cli_run_has_no_underrun(tmp_path, uhd):
    """harness.transmit, as the card's smoke run drives it, with the DAC
    clock on: 0.3 s (2 epochs, one block) is all in the ring before the
    clock starts, so no chunk comes late, and every sample is played."""
    stats, radio, wall = harness.transmit(_argv(tmp_path, 0.3, "--device", "cpu"), uhd, pace=True)
    tx = radio.stream
    assert stats.epochs == 2 and tx.samples == stats.samples == 2 * NUM_IQ_SAMPLES
    assert tx.underruns == 0, tx.underrun_at
    assert tx.preload_s is not None and 0 < tx.max_lead <= FIFO_LENGTH
    assert len(tx.leads) == len(tx.bursts)
    assert wall >= tx.samples / 2.6e6 - 2 * SAMPLES_PER_BUFFER / 2.6e6  # played at the clock


# --- the DAC clock on a hand-fed ring ---------------------------------------
CHUNKS = 4  # the hand-fed ring holds four chunks
RATE = SAMPLES_PER_BUFFER / 0.05  # a chunk plays in 50 ms
STALL_S = 0.4  # longer than the ring (0.2 s) and the chunk the radio holds


def _hand_fed(segments: list, stall_s: float) -> harness.StandInTxStreamer:
    """Feed `segments` (chunk counts) into a ring of CHUNKS chunks, sleeping
    `stall_s` between segments; a consumer thread reads chunks into a
    paced stand-in streamer, as ThreadedRingSink does -> the streamer."""
    ring = IqRing(CHUNKS * SAMPLES_PER_BUFFER)
    tx = harness.StandInTxStreamer(RATE)
    tx.pace(ring, preload=(CHUNKS - 1) * SAMPLES_PER_BUFFER)
    md = harness.stand_in_uhd().types.TXMetadata()

    def consume() -> None:
        while (buf := ring.read(SAMPLES_PER_BUFFER)).size:
            tx.send(buf.reshape(1, -1), md)

    consumer = threading.Thread(target=consume)
    consumer.start()
    try:
        rng = np.random.default_rng(9)
        for i, n in enumerate(segments):
            if i:
                time.sleep(stall_s)
            ring.write(rng.integers(-2000, 2000, 2 * n * SAMPLES_PER_BUFFER).astype(np.int16))
    finally:
        ring.close_write()  # EOF: the consumer plays what is left, then ends
        consumer.join(timeout=30.0)
    assert not consumer.is_alive()
    ring.close()
    return tx


def test_dac_clock_counts_each_stall_once():
    tx = _hand_fed([6, 6, 6], STALL_S)
    assert tx.samples == 18 * SAMPLES_PER_BUFFER
    assert tx.underruns == 2 and tx.late >= 2
    # each late chunk is the first after a stall: played 6 and 12 chunks in
    assert tx.underrun_at == [6 * SAMPLES_PER_BUFFER / RATE, 12 * SAMPLES_PER_BUFFER / RATE]
    assert tx.max_lead <= CHUNKS * SAMPLES_PER_BUFFER


def test_a_late_send_of_a_chunk_the_ring_held_is_not_an_underrun():
    """The thread that calls send sleeps past the due time of a chunk the
    ring already held: one late send, no underrun, and the clock restarts
    there (the next chunk is on time)."""
    ring = IqRing(CHUNKS * SAMPLES_PER_BUFFER)
    try:
        ring.write(np.zeros(2 * CHUNKS * SAMPLES_PER_BUFFER, dtype=np.int16))
        tx = harness.StandInTxStreamer(RATE)
        tx.pace(ring, preload=(CHUNKS - 1) * SAMPLES_PER_BUFFER)
        md = harness.stand_in_uhd().types.TXMetadata()
        for k in range(CHUNKS):
            if k == 2:
                time.sleep(0.12)  # more than the 50 ms the chunk had
            tx.send(ring.read(SAMPLES_PER_BUFFER).reshape(1, -1), md)
    finally:
        ring.close()
    assert (tx.late, tx.underruns) == (1, 0)
    assert 0.05 < tx.most_late_s < 1.0
    assert [lead for _, lead in tx.leads] == [3 * SAMPLES_PER_BUFFER, 2 * SAMPLES_PER_BUFFER,
                                              SAMPLES_PER_BUFFER, 0]


def test_dac_clock_counts_no_underrun_when_the_producer_keeps_up():
    tx = _hand_fed([20], 0.0)
    assert tx.samples == 20 * SAMPLES_PER_BUFFER
    assert tx.underruns == 0, tx.underrun_at
    assert 0 < tx.max_lead <= CHUNKS * SAMPLES_PER_BUFFER
    # while the producer writes, the ring stays full but for the chunk just
    # taken and, at the clock's start, the one the producer has not put back
    assert tx.least_lead((20 - CHUNKS - 1) * SAMPLES_PER_BUFFER) >= (CHUNKS - 2) * SAMPLES_PER_BUFFER
