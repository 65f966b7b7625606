"""The streaming executor's remaining modes on the CPU: pipeline depth > 1
(the producer thread), the device-resident drain (`drain_host=False`)
and checkpoint/resume, held against the port's depth-1 stream and the
JAX package's depth-1 stream on the fixture scene.  The direct engine
in `lut512` is exact across packages, so those streams must be byte-
identical; float-carrier streams are compared within the port, where
the same plain engine makes the same bits."""

import threading
import time

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu import cli as jcli
from galileo_sdr_sim_tpu import scenario as jscn
from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer as JaxStream
from galileo_sdr_sim_tpu.rinex import read_rinex_v3 as j_read_rinex
from galileo_sdr_sim_tpu_torch.checkpoint import load_state, save_state
from galileo_sdr_sim_tpu_torch.harness import JUMP_LLH, AbsSumSink
from galileo_sdr_sim_tpu_torch.io.sinks import NullSink
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch.ops import bandlimit as tbl
from galileo_sdr_sim_tpu_torch.scenario import PositionProvider, ScenarioEngine

from _torch_parity import CPU, LLH, NAV, START, fixture_engine
from conftest import CollectSink

NS, TILE = 8192, 512  # lut512 streams: the direct engine at any width
NS_KP = 10400  # 8 x 1300: the kp engine's smallest epoch


def _jax_engine(duration_s: float):
    nav = j_read_rinex(str(NAV))
    g0 = jscn.scenario_start_time(nav, jcli._parse_time(START))
    return jscn.ScenarioEngine(nav, jscn.PositionProvider(llh_deg=np.array(LLH)), g0, duration_s)


class _Slow(CollectSink):
    """Collects blocks; sleeps per write when `delay` is set, so the
    producer fills its queue and waits (backpressure)."""

    def __init__(self, delay: float = 0.0, stop_after=None):
        super().__init__(stop_after)
        self.delay = delay

    def write(self, b):
        if self.delay:
            time.sleep(self.delay)
        super().write(b)


def _stream(engine, sink=None, **kw) -> np.ndarray:
    sink = sink or CollectSink()
    StreamingSynthesizer(engine, sink, device=CPU, **kw).run()
    return np.concatenate([b.reshape(-1) for b in sink.blocks])


def _lut512(**kw) -> dict:
    return dict(mode="lut512", tile=TILE, block_epochs=2, nsamples=NS, **kw)


def _producer_alive() -> bool:
    return any(t.name == "stream-producer" and t.is_alive() for t in threading.enumerate())


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_pipeline_depth_is_byte_identical(depth):
    """Any depth gives the depth-1 stream in order, byte for byte, also
    when a slow sink makes the producer wait on a full queue; both equal
    the JAX package's depth-1 stream of the same scene."""
    jax_sink = CollectSink()
    JaxStream(_jax_engine(0.9), jax_sink, **_lut512(pipeline_depth=1)).run()
    ref = np.concatenate([b.reshape(-1) for b in jax_sink.blocks])
    base = _stream(fixture_engine(0.9), **_lut512())
    fast = _stream(fixture_engine(0.9), **_lut512(pipeline_depth=depth))
    slow = _stream(fixture_engine(0.9), _Slow(0.03), **_lut512(pipeline_depth=depth))
    assert base.size == 8 * 2 * NS
    np.testing.assert_array_equal(base, ref)
    np.testing.assert_array_equal(fast, ref)
    np.testing.assert_array_equal(slow, ref)
    assert not _producer_alive()


def test_pipeline_stop_ends_the_run_promptly():
    """stop() from the sink ends a depth-2 run after the 2nd or 3rd write
    instead of draining the 5 s scene."""
    sink = NullSink()
    synth = StreamingSynthesizer(fixture_engine(5.0), sink, device=CPU,
                                 **_lut512(pipeline_depth=2))
    writes = []
    inner = sink.write

    def write(iq):
        inner(iq)
        writes.append(1)
        if len(writes) == 2:
            synth.stop()

    sink.write = write
    stats = synth.run()
    assert 2 <= len(writes) <= 3
    assert stats.epochs < 49
    assert not _producer_alive()


class _Failing:
    """The fixture scene, whose third block raises in scenario stepping:
    on the producer thread at depth >= 2."""

    def __init__(self):
        self._engine = fixture_engine(0.9)
        self.model = self._engine.model

    def batches(self, block_epochs, start=1):
        for i, batch in enumerate(self._engine.batches(block_epochs, start=start)):
            if i == 2:
                raise RuntimeError("scenario fault in block 3")
            yield batch


@pytest.mark.parametrize("depth", [1, 3])
def test_producer_exception_reaches_the_caller(depth):
    sink = CollectSink()
    synth = StreamingSynthesizer(_Failing(), sink, device=CPU, **_lut512(pipeline_depth=depth))
    with pytest.raises(RuntimeError, match="scenario fault in block 3"):
        synth.run()
    assert len(sink.blocks) <= 2
    assert not _producer_alive()


def test_depth_4_equals_depth_1_across_the_reallocation_boundary():
    """31 s: the 30 s ephemeris refresh and channel reallocation, and the
    page rollovers, with the scenario stepped on the producer thread."""
    kw = dict(mode="lut512", tile=TILE, block_epochs=8, nsamples=2600)
    a = _stream(fixture_engine(31.0), **kw)
    b = _stream(fixture_engine(31.0), **kw, pipeline_depth=4)
    assert a.size == 309 * 2 * 2600
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route, depth", [
    ("kp", 1), ("kp", 3), ("lut512", 1), ("bandlimit", 1), ("bandlimit", 2),
])
def test_device_resident_drain_totals(route, depth):
    """drain_host=False: every block reaches the sink as a torch.Tensor on
    the run's device (kp blocks in the packed int32 (B, n_k, 1300)
    layout, sliced when partial; the band-limited and direct ones as
    (n, 2 nsamples) int16), and the sink's per-block sums of |x| equal
    those of the host drain.  Blocks of 3 epochs: a full and a partial
    one."""
    model = E1_CBOC if route == "bandlimit" else None
    kw = dict(block_epochs=3, nsamples=NS_KP, pipeline_depth=depth)
    if route == "lut512":
        kw.update(mode="lut512", tile=2048)
    if route == "bandlimit":
        kw.update(bandlimit=True)

    def engine():
        return fixture_engine(0.5, model) if model else fixture_engine(0.5)

    shapes = []

    class Device(AbsSumSink):
        def write(self, block):
            shapes.append((tuple(block.shape), block.dtype))
            super().write(block)

    dev, host = Device(), AbsSumSink()
    StreamingSynthesizer(engine(), dev, device=CPU, drain_host=False, **kw).run()
    StreamingSynthesizer(engine(), host, device=CPU, **kw).run()
    assert dev.kinds == ["cpu", "cpu"] and host.kinds == ["numpy", "numpy"]
    assert dev.sums == host.sums and all(s > 0 for s in dev.sums)
    if route == "kp":
        assert shapes == [((3, 8, 1300), torch.int32), ((1, 8, 1300), torch.int32)]
    else:
        assert shapes == [((3, 2 * NS_KP), torch.int16), ((1, 2 * NS_KP), torch.int16)]


# --- checkpoint / resume (tests/test_checkpoint.py on the port) -------------


def test_snapshot_round_trip(tmp_path):
    eng = fixture_engine(1.5)
    gen = eng.epochs()
    for _ in range(6):
        next(gen)
    save_state(eng, tmp_path / "ckpt")
    eng2 = fixture_engine(1.5)
    done = load_state(eng2, tmp_path / "ckpt")
    assert done == 6
    rest_a, rest_b = list(gen), list(eng2.epochs(start=done + 1))
    assert len(rest_a) == len(rest_b) > 0
    for ta, tb in zip(rest_a, rest_b):
        for f in ("prn", "f_carr", "carr_phase0", "code_phase0", "sym_win", "ibit0"):
            assert np.array_equal(getattr(ta, f), getattr(tb, f)), f


def test_streaming_resume(tmp_path):
    """A run that snapshots every 4 epochs; a new run with the same
    snapshot path resumes after it instead of restarting."""
    ck = str(tmp_path / "stream_ckpt")
    kw = dict(nsamples=NS_KP, block_epochs=2, checkpoint_path=ck, checkpoint_every=4)
    stats1 = StreamingSynthesizer(fixture_engine(1.0), NullSink(), device=CPU, **kw).run()
    assert stats1.epochs == 9
    s2 = StreamingSynthesizer(fixture_engine(1.0), NullSink(), device=CPU, **kw)
    assert s2._start_epoch > 1
    stats2 = s2.run()
    assert stats2.epochs == 9 - (s2._start_epoch - 1)


@pytest.mark.parametrize("mode", ["lut512", "float"])
def test_pipelined_resume_does_not_skip_inflight_blocks(tmp_path, mode):
    """Depth 3, a snapshot every block, and a sink that stops the run
    after 3 blocks while the producer is blocks ahead: the snapshot holds
    the sink's position, and the drained blocks followed by the resumed
    run's equal one uninterrupted depth-1 run byte for byte (under
    lut512 also the JAX package's depth-1 stream)."""
    kw = dict(nsamples=NS_KP, block_epochs=2, mode=mode)
    if mode == "lut512":
        kw["tile"] = 2048
    ref = _stream(fixture_engine(2.0), **kw)
    if mode == "lut512":
        jax_sink = CollectSink()
        JaxStream(_jax_engine(2.0), jax_sink, **kw).run()
        np.testing.assert_array_equal(ref, np.concatenate([b.reshape(-1) for b in jax_sink.blocks]))

    ck = str(tmp_path / "pipe_ckpt")
    s1_sink = CollectSink(stop_after=3)
    s1 = StreamingSynthesizer(fixture_engine(2.0), s1_sink, device=CPU, pipeline_depth=3,
                              checkpoint_path=ck, checkpoint_every=2, **kw)
    s1_sink.synth = s1
    s1.run()
    drained = sum(b.shape[0] for b in s1_sink.blocks)
    assert drained == 6

    s2_sink = CollectSink()
    s2 = StreamingSynthesizer(fixture_engine(2.0), s2_sink, device=CPU, pipeline_depth=3,
                              checkpoint_path=ck, checkpoint_every=10_000, **kw)
    assert s2._start_epoch == drained + 1
    s2.run()
    combined = np.concatenate([b.reshape(-1) for b in s1_sink.blocks + s2_sink.blocks])
    np.testing.assert_array_equal(combined, ref)


def test_live_position_resume_replays_inflight_epochs(tmp_path):
    """With a live position source, a snapshot rewound to the sink's
    position replays the in-flight tables instead of stepping those
    epochs again."""
    nav = fixture_engine(0.1).nav

    def mk():
        return ScenarioEngine(nav, PositionProvider(live=lambda: np.array(LLH)),
                              fixture_engine(0.1).g0, 1.5)

    eng = mk()
    eng._replay_keep = 16
    gen = eng.epochs()
    tabs = [next(gen) for _ in range(8)]  # the producer 8 epochs ahead
    save_state(eng, tmp_path / "ck", drained_iumd=4)  # the sink has 4
    eng2 = mk()
    done = load_state(eng2, tmp_path / "ck")
    assert done == 4
    resumed = list(eng2.epochs(start=done + 1))
    assert len(resumed) == len(tabs) - 4 + (len(list(mk().epochs())) - 8)
    for ta, tb in zip(tabs[4:8], resumed[:4]):
        for f in ("f_carr", "code_phase0", "carr_phase0", "sym_win"):
            assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
        assert ta.grx_sec == tb.grx_sec


@pytest.mark.parametrize("scene, drained", [("static", 12), ("static", 16), ("jump", 292)])
def test_live_position_batches_resume_from_a_rewound_snapshot(tmp_path, scene, drained):
    """batches(8) over a live position, which steps a block at a time, with
    the executor's replay ring at pipeline depth 2 ((2 + 2) * 8 epochs)
    and the producer two blocks or more ahead of the sink; a snapshot
    rewound to the sink's epoch resumes with the in-flight tables
    replayed, then stepped ones, and each table from epoch `drained` + 1
    on equals an uninterrupted run's.  Static: at 12, inside the second
    block, the resumed run's second batch is four replayed tables and four
    stepped; at 16, at its end.  "jump": the receiver jumps at epoch 150
    and the 30 s reallocation at epoch 299 changes the channel map inside
    the replayed tables, so the first resumed batch ends there."""
    nav = fixture_engine(0.1).nav
    duration = 32.0 if scene == "jump" else 6.0

    def mk(stepped=0):
        """An engine whose callback reads as if `stepped` epochs had been."""
        reads = [stepped]

        def live():
            reads[0] += 1
            return np.array(JUMP_LLH if scene == "jump" and reads[0] > 150 else LLH)

        return ScenarioEngine(nav, PositionProvider(live=live), fixture_engine(0.1).g0, duration)

    def tables(batches):
        per_epoch = {f: np.concatenate([getattr(b, f) for b in batches])
                     for f in ("grx_sec", "f_carr", "f_code", "code_phase0", "carr_phase0",
                               "sym_win", "pilot_win", "gain")}
        per_epoch["prn"] = np.concatenate([np.tile(b.prn, (b.f_code.shape[0], 1))
                                           for b in batches])
        return per_epoch

    eng = mk()
    eng._replay_keep = (2 + 2) * 8
    gen, ahead = eng.batches(8), 0
    while ahead <= drained + 16:
        ahead += next(gen).f_code.shape[0]
    save_state(eng, tmp_path / "ck", drained_iumd=drained)
    eng2 = mk(stepped=ahead)
    assert load_state(eng2, tmp_path / "ck") == drained
    resumed = list(eng2.batches(8, start=drained + 1))
    whole = tables(list(mk().batches(8)))
    got = tables(resumed)
    sizes = [b.f_code.shape[0] for b in resumed]
    assert sizes[:2] == ([7, 8] if scene == "jump" else [8, 8]), sizes
    assert got["grx_sec"].size == whole["grx_sec"].size - drained > ahead - drained
    for name, values in got.items():
        assert np.array_equal(values, whole[name][drained:]), name


def test_bandlimit_resume_restarts_the_filter_at_zeros(tmp_path):
    """The documented seam (docs/bandlimit.md): a resumed --bandlimit run
    filters its first block from the zero overlap state, so that block
    equals a fresh band-limited synthesis of the same scenario block."""
    kw = dict(nsamples=NS_KP, block_epochs=2, bandlimit=True, checkpoint_path=str(tmp_path / "bl"),
              checkpoint_every=2)
    s1_sink = CollectSink(stop_after=2)
    s1 = StreamingSynthesizer(fixture_engine(1.0, E1_CBOC), s1_sink, device=CPU, **kw)
    s1_sink.synth = s1
    s1.run()
    s2_sink = CollectSink()
    s2 = StreamingSynthesizer(fixture_engine(1.0, E1_CBOC), s2_sink, device=CPU, **kw)
    start = s2._start_epoch
    assert start == 1 + sum(b.shape[0] for b in s1_sink.blocks) > 1
    s2.run()
    batch = list(fixture_engine(1.0, E1_CBOC).batches(2))[(start - 1) // 2]
    fresh, _ = tbl.synth_block_cboc_bandlimited(batch, NS_KP, pad_epochs=2, device=CPU)
    np.testing.assert_array_equal(s2_sink.blocks[0], fresh.numpy()[: batch.f_code.shape[0]])
    # the uninterrupted run's block differs: its filter carries history
    whole = _stream(fixture_engine(1.0, E1_CBOC), nsamples=NS_KP, block_epochs=2, bandlimit=True)
    n = 2 * NS_KP * (start - 1)
    assert not np.array_equal(whole[n: n + s2_sink.blocks[0].size], s2_sink.blocks[0].reshape(-1))
