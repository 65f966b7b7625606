"""The port's own host layer against the JAX package's, on the CPU.

The port keeps a copy of each JAX-free module of the reference it needs
(RINEX reader, scenario engine and what it stands on, signal models,
sinks, noise, the receiver's acquisition stage, the CLI's parser and
helpers), so that it imports nothing of the JAX package.  Each copy is
held to its original here with exact equality (`==`, `np.array_equal`):
they do the same float64 arithmetic, so no tolerance applies.  The
scenario cases walk the fixture scene at B = 8 epochs a block: 60 s of
the default sine-BOC model (two 30 s I/NAV subframes, which between them
carry every word type, the fec2 Reed-Solomon pages included), and 30 s
of CBOC, without ionosphere, with the dummy almanac, and with a
user-motion trajectory that jumps (a channel reallocation at the 30 s
boundary and a block outside the kp engine's code-Doppler envelope).  A
live position, which the port steps a block at a time and the JAX
package an epoch at a time, gives the same batches at B = 1, 3 and 8 (a
static, a moving and a jumping receiver, and a TOW correction that comes
mid-run, which the port applies at the next chunk it steps), and each
position is read once, no earlier than the JAX package reads it; a TOW
correction moves the clock before a chunk is sized.  The checkpoint copy writes the same snapshot as its
original, and a snapshot the JAX package wrote resumes in the port; the
receiver's decode and PVT copies (`rx`, `rx_pvt`) give their originals'
results on pages of the fixture nav file made by the port's I/NAV
encoder, with seeded symbol errors, and on seeded pseudoranges."""

import dataclasses

import numpy as np
import pytest

from galileo_sdr_sim_tpu import checkpoint as jckpt
from galileo_sdr_sim_tpu import cli as jcli
from galileo_sdr_sim_tpu import noise as jnoise
from galileo_sdr_sim_tpu import rx as jrxd
from galileo_sdr_sim_tpu import rx_pvt as jpvt
from galileo_sdr_sim_tpu import rx_track as jrx
from galileo_sdr_sim_tpu import scenario as jscn
from galileo_sdr_sim_tpu.models.cboc import E1_CBOC as J_CBOC
from galileo_sdr_sim_tpu.models.e1 import E1_OS as J_E1
from galileo_sdr_sim_tpu.rinex import read_rinex_v3 as j_read_rinex
from galileo_sdr_sim_tpu_torch import checkpoint as tckpt
from galileo_sdr_sim_tpu_torch import cli as tcli
from galileo_sdr_sim_tpu_torch import inav as tinav
from galileo_sdr_sim_tpu_torch import noise as tnoise
from galileo_sdr_sim_tpu_torch import rx as trxd
from galileo_sdr_sim_tpu_torch import rx_pvt as tpvt
from galileo_sdr_sim_tpu_torch import rx_track as trx
from galileo_sdr_sim_tpu_torch import scenario as tscn
from galileo_sdr_sim_tpu_torch.observables import compute_range
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC as T_CBOC
from galileo_sdr_sim_tpu_torch.models.e1 import E1_OS as T_E1
from galileo_sdr_sim_tpu_torch.ops.synth_kp import (
    mu_in_envelope, packed_to_iq16, prepare_kp_inputs,
)
from galileo_sdr_sim_tpu_torch.ops.synth_kp_cuda import synth_kp_packed
from galileo_sdr_sim_tpu_torch.profiling import Timer, installed
from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3 as t_read_rinex

from _torch_parity import CPU, LLH, NAV, START

JUMP_LLH = (30.0, -71.0589, 2.0)  # 1370 km south of the fixture site


def _motion_file(tmp_path):
    """10 Hz lat,lon,hgt rows: 15 s at the fixture site, then a jump."""
    path = tmp_path / "jump.csv"
    rows = [LLH] * 150 + [JUMP_LLH] * 170
    path.write_text("".join(",".join(str(v) for v in row) + "\n" for row in rows))
    return str(path)


def _engines(case: str, tmp_path):
    """[JAX engine, port engine] of one scenario case, each built from its
    own package only, as its CLI builds it."""
    duration = {"e1": 60.0, "motion_jump": 32.0}.get(case, 30.0)
    engines = []
    for read, scn, cli, model in ((j_read_rinex, jscn, jcli, J_CBOC if case == "cboc" else J_E1),
                                  (t_read_rinex, tscn, tcli, T_CBOC if case == "cboc" else T_E1)):
        nav = read(str(NAV))
        if case == "iono_off":
            nav.iono.enable = False
        if case == "dummy_almanac":
            nav.dummy_almanac = True
        if case == "motion_jump":
            position = scn.PositionProvider(trajectory=cli.load_user_motion(_motion_file(tmp_path)))
        else:
            position = scn.PositionProvider(llh_deg=np.array(LLH))
        g0 = scn.scenario_start_time(nav, cli._parse_time(START))
        engines.append(scn.ScenarioEngine(nav, position, g0, duration, model=model))
    return engines


def test_read_rinex_matches():
    j, t = j_read_rinex(str(NAV)), t_read_rinex(str(NAV))
    assert sum(len(recs) for recs in t.eph) == sum(len(recs) for recs in j.eph) > 0
    assert dataclasses.asdict(t.iono) == dataclasses.asdict(j.iono)
    for recs_j, recs_t in zip(j.eph, t.eph, strict=True):
        assert [dataclasses.asdict(e) for e in recs_t] == [dataclasses.asdict(e) for e in recs_j]
    assert ([dataclasses.asdict(g) for g in t.time_window()]
            == [dataclasses.asdict(g) for g in j.time_window()])


@pytest.mark.parametrize("case", ["e1", "cboc", "iono_off", "dummy_almanac", "motion_jump"])
def test_scenario_engine_batches_match(case, tmp_path):
    j_engine, t_engine = _engines(case, tmp_path)
    assert len(t_engine) == len(j_engine)
    fields = [f.name for f in dataclasses.fields(tscn.EpochBatch)]
    assert fields == [f.name for f in dataclasses.fields(jscn.EpochBatch)]
    n_epochs, prn_maps, outside = 0, set(), 0
    for bj, bt in zip(j_engine.batches(8), t_engine.batches(8), strict=True):
        for name in fields:
            a, b = getattr(bt, name), getattr(bj, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (case, n_epochs, name)
        n_epochs += bt.f_code.shape[0]
        prn_maps.add(tuple(bt.prn))
        outside += not mu_in_envelope(bt.f_code)
    assert n_epochs == len(t_engine) > 0
    if case == "motion_jump":
        assert len(prn_maps) >= 2 and outside >= 1, (prn_maps, outside)


class _TowRelay:
    """A nav-bit relay that relays no symbols and reports a TOW correction
    of `shift` seconds once the position has been read `at` times (before
    epoch `at` is stepped), or from the start (`at` None)."""

    def __init__(self, reads: list, at: int | None, shift: float = 0.3):
        self._reads, self._at, self._shift = reads, at, shift

    @property
    def tow_correction(self):
        return self._shift if self._at is None or self._reads[0] >= self._at else None

    def pop_bits(self, prn, n):
        return []


def _live_position(case: str, tow_at: int):
    """-> (a live position callback, a bit relay or None): the fixture site
    on every read ("static"), a receiver that moves on every read
    ("moving"), or the fixture site for the first 150 reads and JUMP_LLH
    after them ("jump", and "tow" behind a _TowRelay that reports 0.3 s
    before epoch `tow_at`: the 30 s reallocation then changes the channel
    map)."""
    reads = [0]

    def read():
        reads[0] += 1
        if case == "moving":
            return np.array(LLH) + np.array([2e-6, -3e-6, 0.05]) * reads[0]
        return np.array(JUMP_LLH if case in ("jump", "tow") and reads[0] > 150 else LLH)

    return read, _TowRelay(reads, tow_at) if case == "tow" else None


def _live_engines(case: str, yields: dict | None = None, reads: list | None = None,
                  tow_at: dict | None = None):
    """[JAX engine, port engine] of the fixture scene with live position
    `case`, 31 s (across the 30 s reallocation) or 6 s ("moving"); under
    "tow" the relay of each package reports the correction before the
    epoch `tow_at` gives it (282 by default); with `reads`, each engine's
    callback appends (package, yields[package]) to it: the batches its
    consumer had been handed at the read."""
    duration = 6.0 if case == "moving" else 31.0
    engines = []
    for name, read_nav, scn, cli in (("jax", j_read_rinex, jscn, jcli),
                                     ("port", t_read_rinex, tscn, tcli)):
        nav = read_nav(str(NAV))
        g0 = scn.scenario_start_time(nav, cli._parse_time(START))
        live, relay = _live_position(case, (tow_at or {}).get(name, 282))
        if reads is not None:
            def live(live=live, name=name):
                reads.append((name, yields[name]))
                return live()
        engines.append(scn.ScenarioEngine(nav, scn.PositionProvider(live=live), g0, duration,
                                          bit_source=relay))
    return engines


@pytest.mark.parametrize("block_epochs", [1, 3, 8])
@pytest.mark.parametrize("case", ["static", "moving", "jump", "tow"])
def test_live_engine_batches_match(case, block_epochs):
    """The port steps a live position a block at a time (one `_step_block`
    a block, a one-epoch chunk at B = 1); the JAX package an epoch at a
    time (its `_step`).  Every batch is the same, bit for bit, with the
    same lengths, the short ones at the channel-map change of "jump" and
    "tow" included.  Under "tow" the TOW correction, which a relay sends
    at no set epoch, arrives before epoch 282: the JAX package applies it
    there, the port at the first epoch of the next chunk it steps (282 at
    B = 1, 283 at B = 3, 289 at B = 8), so the port is held to a JAX
    engine whose correction arrives before that epoch; in both the 30 s
    reallocation moves from epoch 299 to 296."""
    tow_at = None
    if case == "tow":
        sizes = [b.f_code.shape[0] for b in _live_engines(case)[1].batches(block_epochs)]
        starts = np.cumsum([1, *sizes]).tolist()
        landed = min(s for s in starts if s >= 282)
        assert landed == {1: 282, 3: 283, 8: 289}[block_epochs]
        tow_at = {"jax": landed, "port": 282}
    j_engine, t_engine = _live_engines(case, tow_at=tow_at)
    fields = [f.name for f in dataclasses.fields(tscn.EpochBatch)]
    lengths, prn_maps = [], []
    for bj, bt in zip(j_engine.batches(block_epochs), t_engine.batches(block_epochs),
                      strict=True):
        for name in fields:
            a, b = getattr(bt, name), getattr(bj, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (case, len(lengths), name)
        lengths.append(bt.f_code.shape[0])
        prn_maps.append(tuple(bt.prn))
    assert sum(lengths) == len(t_engine) > 0
    if case in ("jump", "tow"):
        # a batch ends at the 30 s reallocation, which changes the map
        cut = 296 if case == "tow" else 299
        ends = np.cumsum(lengths).tolist()
        assert cut in ends and prn_maps[ends.index(cut)] != prn_maps[ends.index(cut) + 1]
        assert len(set(prn_maps)) == 2


class _FlippedE1(T_E1.__class__):
    """A model with its own data table: the sine-BOC E1B rows negated."""

    @property
    def data_codes(self):
        return -T_E1.data_codes


@pytest.mark.parametrize("block_epochs", [1, 8])
@pytest.mark.parametrize("model", ["e1", "cboc", "flipped"])
def test_pack_keeps_the_code_rows_while_the_map_holds(model, block_epochs):
    """The port's `_pack` builds a block's code rows only when the PRN map
    changes and hands the same read-only rows to every batch of a map:
    through the 30 s reallocation of a jumping live receiver, every
    batch's rows equal rows copied afresh from the model's tables for
    its map (a model with its own table gets its own rows), and the
    `pack/codes/rows` span opens once a map."""
    signal = {"e1": T_E1, "cboc": T_CBOC, "flipped": _FlippedE1()}[model]
    nav = t_read_rinex(str(NAV))
    g0 = tscn.scenario_start_time(nav, tcli._parse_time(START))
    live, _ = _live_position("jump", 0)
    engine = tscn.ScenarioEngine(nav, tscn.PositionProvider(live=live), g0, 31.0, model=signal)
    timer = Timer()
    maps, changes, prev = set(), 0, None
    with installed(timer):
        batches = list(engine.batches(block_epochs))
    data, pilot = signal.data_codes, signal.pilot_codes
    for batch in batches:
        for got, table in ((batch.codes_b, data), (batch.codes_c, pilot)):
            want = np.zeros((len(batch.prn), signal.boc_length), data.dtype)
            for slot, prn in enumerate(batch.prn):
                if prn > 0:
                    want[slot] = table[prn - 1]
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            assert not got.flags.writeable
        same = prev is not None and np.array_equal(batch.prn, prev.prn)
        if prev is not None:
            assert (batch.codes_b is prev.codes_b) is same
            assert (batch.codes_c is prev.codes_c) is same
        changes += not same
        maps.add(batch.prn.tobytes())
        prev = batch
    assert len(maps) == changes == 2
    assert timer.counts["pack/codes/rows"] == len(maps)
    assert timer.counts["pack/codes"] == timer.counts["pack"] == len(batches)
    if model == "flipped":
        active = batches[0].prn > 0
        assert np.array_equal(batches[0].codes_b[active],
                              -T_E1.data_codes[batches[0].prn[active] - 1])


def test_tow_correction_moves_the_clock_before_the_chunk_is_sized():
    """A TOW correction of 28 s moves the 30 s boundary from epoch 299 to
    epoch 19, inside the first chunk of 32 epochs that a static position
    steps: the chunk is sized on the corrected clock, so it ends at epoch
    19 and the reallocation happens there, and every table equals the one
    a live position gives at B = 1, stepped in one-epoch chunks.  Both
    step through `_step_block`; the live B = 1 tables of a TOW-relayed
    run are held to the JAX engine's `_step` by
    test_live_engine_batches_match[tow-1]."""
    nav = t_read_rinex(str(NAV))
    g0 = tscn.scenario_start_time(nav, tcli._parse_time(START))
    tables, reallocs = [], []
    for position in (tscn.PositionProvider(llh_deg=np.array(LLH)),
                     tscn.PositionProvider(live=lambda: np.array(LLH))):
        engine = tscn.ScenarioEngine(nav, position, g0, 4.0,
                                     bit_source=_TowRelay([0], None, 28.0))
        timer = Timer()
        with installed(timer):
            tables.append(list(engine.epochs()))
        reallocs.append(timer.counts.get("realloc", 0))
    assert reallocs == [1, 1]
    assert len(tables[0]) == len(tables[1]) == 39
    for a, b in zip(*tables):
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name


class _LateTowRelay(_TowRelay):
    """A _TowRelay whose correction reads None on its first read and
    `shift` seconds on every later one: the relay's thread sets it just
    after the engine first looked."""

    def __init__(self, shift: float):
        super().__init__([0], None, shift)
        self.n_reads = 0

    @property
    def tow_correction(self):
        self.n_reads += 1
        return None if self.n_reads == 1 else self._shift


def test_tow_correction_is_read_once_a_chunk():
    """The TOW correction is read once a chunk, before the chunk is sized.
    A 28 s correction that is set just after the first chunk of 32 static
    epochs was sized lands on the first epoch of the next chunk, epoch 33,
    and moves the 30 s boundary to epoch 319: every stepped table on a
    30 s boundary is followed by a reallocation.  (Read again inside the
    chunk, it would move the clock under a chunk sized on the old one,
    which would then cross the boundary at epoch 19 without ending
    there, and skip that reallocation.)"""
    nav = t_read_rinex(str(NAV))
    g0 = tscn.scenario_start_time(nav, tcli._parse_time(START))
    relay = _LateTowRelay(28.0)
    engine = tscn.ScenarioEngine(nav, tscn.PositionProvider(llh_deg=np.array(LLH)), g0, 33.0,
                                 bit_source=relay)
    timer = Timer()
    with installed(timer):
        tables = list(engine.epochs())
    assert len(tables) == 329
    grx = np.array([t.grx_sec for t in tables])
    # epoch e is tables[e - 1]
    boundary = [e for e, sec in enumerate(grx, 1) if int(sec * 10.0 + 0.5) % 300 == 0]
    assert timer.counts.get("realloc", 0) == len(boundary)
    assert boundary == [319]
    # the clock jumps between epochs 32 and 33
    assert (np.flatnonzero(np.diff(grx) > 1.0) + 2).tolist() == [33]
    assert relay.n_reads == 2


@pytest.mark.parametrize("first", [(3,), (1, 1, 3)])
def test_compute_range_user_cache_keys_on_the_shape(first):
    """compute_range caches the receiver's geodesy of the last position.
    A one-epoch chunk passes its position as (1, 1, 3), with the bytes of
    the (3,) one that channel allocation passes at the same place; each
    call after the other gives what it gives after another position."""
    from galileo_sdr_sim_tpu_torch.constants import D2R
    from galileo_sdr_sim_tpu_torch.geodesy import llh2xyz

    nav = t_read_rinex(str(NAV))
    g0 = tscn.scenario_start_time(nav, tcli._parse_time(START))
    eph = next(recs[0] for recs in nav.eph if recs)
    xyz = llh2xyz(np.array([LLH[0] * D2R, LLH[1] * D2R, LLH[2]]))
    then = (1, 1, 3) if first == (3,) else (3,)

    def at(shape, shift=0.0):
        return compute_range(eph, nav.iono, g0.week, g0.sec, (xyz + shift).reshape(shape))

    at(then, 1.0)
    want = at(then)
    at(first)
    got = at(then)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.shape(a) == np.shape(b) and np.array_equal(a, b), f.name


@pytest.mark.parametrize("block_epochs", [1, 3, 8])
def test_live_position_is_read_once_an_epoch_no_earlier(block_epochs):
    """Each epoch's live position is read once, in epoch order, after the
    batch before its own was yielded and before its own is, also at the
    channel-map change; never earlier than the JAX package's engine reads
    it (which at B > 1 steps each batch's next epoch before yielding it),
    and at B = 1 as it does."""
    yields, reads = {"jax": 0, "port": 0}, []
    engines = _live_engines("jump", yields, reads)
    sizes = {}
    for name, engine in zip(("jax", "port"), engines):
        sizes[name] = []
        for batch in engine.batches(block_epochs):
            sizes[name].append(batch.f_code.shape[0])
            yields[name] += 1
    assert sizes["port"] == sizes["jax"]
    seen = {name: [y for who, y in reads if who == name] for name in ("jax", "port")}
    # the constructor's read of epoch 0, then one read an epoch
    assert len(seen["port"]) == len(seen["jax"]) == 1 + len(engines[1])
    block_of = np.repeat(np.arange(len(sizes["port"])), sizes["port"])
    assert seen["port"] == [0, *block_of.tolist()]
    assert all(p >= j for p, j in zip(seen["port"], seen["jax"]))
    if block_epochs == 1:
        assert seen["port"] == seen["jax"]


def test_awgn_sink_matches():
    class Collect:
        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block, copy=True))

        def close(self):
            pass

    rng = np.random.default_rng(11)
    blocks = [rng.integers(-2000, 2000, (2, 2 * 2600)).astype(np.int16) for _ in range(3)]
    out = []
    for mod in (jnoise, tnoise):
        inner = Collect()
        sink = mod.AwgnSink(inner, 45.0, seed=7)
        for block in blocks:
            sink.write(block)
        sink.close()
        out.append(inner.blocks)
    assert len(out[0]) == len(out[1]) == 3
    for a, b in zip(*out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(out[1][0], blocks[0])


def test_acquire_matches_on_a_port_made_stream():
    """The first 8 ms of the fixture scene's first epoch, made by the
    port's plain kp engine; each package's receiver acquires every
    visible PRN and two absent ones, with the same result."""
    batch = next(tscn.ScenarioEngine(
        t_read_rinex(str(NAV)), tscn.PositionProvider(llh_deg=np.array(LLH)),
        tscn.scenario_start_time(t_read_rinex(str(NAV)), tcli._parse_time(START)), 1.0,
    ).batches(8))
    inputs = prepare_kp_inputs(batch, 16 * 1300, pad_epochs=8, device=CPU)
    iq = packed_to_iq16(synth_kp_packed(inputs, 16).numpy())[0]
    xt, xj = trx.iq_to_complex(iq), jrx.iq_to_complex(iq)
    assert np.array_equal(xt, xj)
    visible = [int(p) for p in batch.prn if p > 0]
    for prn in [*visible, 1, 2]:
        got, want = trx.acquire(xt, prn), jrx.acquire(xj, prn)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), prn
        if prn in visible:
            assert got.metric >= 8.0


def test_load_user_motion_matches(tmp_path):
    llh = tmp_path / "llh.csv"
    llh.write_text("# lat,lon,hgt\n42.3601,-71.0589,2\n\n42.3602 -71.0590 3.5\n")
    ecef = tmp_path / "ecef.csv"
    ecef.write_text("0.0,1527000.1,-4465000.2,4275000.3\n0.1,1527001.0,-4465001.0,4275001.0\n")
    for path in (llh, ecef):
        got, want = tcli.load_user_motion(str(path)), jcli.load_user_motion(str(path))
        assert got.shape == want.shape == (2, 3) and np.array_equal(got, want)
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n")
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit, match="unrecognized user-motion format"):
            cli.load_user_motion(str(bad))


@pytest.mark.parametrize("text", [
    START, "2022/02/20,08:00:01", "2024/12/31,23:59:59.9", "1980/01/06,00:00:00",
    "2022/13/01,00:00:00", "2022-02-20 08:00:01",
])
def test_parse_time_matches(text):
    outcomes = []
    for cli in (tcli, jcli):
        try:
            g = cli._parse_time(text)
            outcomes.append((g.week, g.sec))
        except SystemExit as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


def test_parser_and_argv_helpers_match():
    """The port's parser has every flag of the reference's, with the same
    destinations, defaults, nargs, constants and choices."""
    def shape(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const, a.choices, a.type)
                for a in parser._actions}

    assert shape(tcli.build_parser()) == shape(jcli.build_parser())
    argv = ["-l", "-33.9,151.2,10", "-t", "2022/02/20,08:00:01", "-d", "-5", "-o", "x"]
    assert tcli._glue_negative_values(argv) == jcli._glue_negative_values(argv)


def test_native_fifo_sink_matches(tmp_path):
    """The port's ring builds the checkout's native/iqring.cpp into its own
    build directory and writes the same file as the reference's ring."""
    from galileo_sdr_sim_tpu.io.native_fifo import NativeFifoSink as JaxFifo
    from galileo_sdr_sim_tpu_torch.io import native_fifo
    from galileo_sdr_sim_tpu_torch.ops import _build

    data = np.random.default_rng(3).integers(-500, 500, 2 * 30_000, dtype=np.int16)
    outs = []
    for name, sink_cls in (("jax", JaxFifo), ("port", native_fifo.NativeFifoSink)):
        out = tmp_path / f"{name}.ishort"
        sink = sink_cls(str(out), capacity_samples=4096)
        for off in range(0, data.size, 2 * 7000):
            sink.write(data[off: off + 2 * 7000])
        sink.close()
        outs.append(np.fromfile(out, dtype=np.int16))
    assert np.array_equal(outs[0], data) and np.array_equal(outs[1], data)
    assert native_fifo._build_library().parent == _build.BUILD_DIR


def test_native_fifo_refuses_a_missing_source(tmp_path, monkeypatch):
    from galileo_sdr_sim_tpu_torch.io import native_fifo

    monkeypatch.setattr(native_fifo, "_SOURCE", tmp_path / "iqring.cpp")
    with pytest.raises(RuntimeError, match="source not found"):
        native_fifo._build_library()


# --- checkpoint ---------------------------------------------------------------


def _step(engine, blocks: int) -> int:
    """Hand out `blocks` batches of 8 epochs; -> the epochs handed out."""
    gen = engine.batches(8)
    return sum(next(gen).f_code.shape[0] for _ in range(blocks))


@pytest.mark.parametrize("case, blocks, drained", [
    ("e1", 3, None), ("e1", 3, 8), ("cboc", 2, 8), ("motion_jump", 20, 144),
])
def test_checkpoint_snapshots_match(case, blocks, drained, tmp_path):
    """Each package's save_state on its own engine after the same epochs
    were handed out (with `drained`, rewound to that epoch through the
    replay ring, as a pipelined run's snapshot is) writes the same JSON
    and npz arrays.  The port's engine hands out `blocks` batches of 8,
    which step no epoch ahead of the last batch; the JAX package's engine
    hands out as many epochs one at a time (`epochs`), since its `batches`
    steps the next batch's first epoch, and so at a chunk's end the next
    chunk, before it yields a batch."""
    j_engine, t_engine = _engines(case, tmp_path)
    for engine in (j_engine, t_engine):
        engine._replay_keep = 32
    handed_out = _step(t_engine, blocks)
    epochs = j_engine.epochs()
    for _ in range(handed_out):
        next(epochs)
    for engine, ckpt, name in ((j_engine, jckpt, "jax"), (t_engine, tckpt, "port")):
        ckpt.save_state(engine, tmp_path / name, drained_iumd=drained)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert drained is None or "pending_prn" in a.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """A snapshot the JAX package wrote (rewound to epoch 16 of 24 stepped)
    loads into a fresh port engine, which goes on with the tables of an
    uninterrupted JAX engine from epoch 17."""
    j_engine, t_engine = _engines("e1", tmp_path)
    j_engine._replay_keep = 32
    _step(j_engine, 3)
    jckpt.save_state(j_engine, tmp_path / "ck", drained_iumd=16)
    assert tckpt.load_state(t_engine, tmp_path / "ck") == 16
    whole = _engines("e1", tmp_path)[0].batches(8)
    _step_gen = [next(whole) for _ in range(2)]
    assert sum(b.f_code.shape[0] for b in _step_gen) == 16
    fields = [f.name for f in dataclasses.fields(tscn.EpochBatch)]
    for i, bt in zip(range(5), t_engine.batches(8, start=17)):
        bj = next(whole)
        for name in fields:
            a, b = getattr(bt, name), getattr(bj, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, name)


# --- the receiver's decode and PVT stages -------------------------------------


def _fixture_ephemerides():
    """(nav, g0, {prn: ephemeris}) of the fixture scene's visible PRNs."""
    nav = t_read_rinex(str(NAV))
    g0 = tscn.scenario_start_time(nav, tcli._parse_time(START))
    batch = next(tscn.ScenarioEngine(nav, tscn.PositionProvider(llh_deg=np.array(LLH)), g0, 1.0)
                 .batches(8))
    prns = [int(p) for p in batch.prn if p > 0]
    return nav, g0, {prn: nav.eph[prn - 1][nav.epoch_match(prn - 1, g0)] for prn in prns}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_decode_matches(seed):
    rng = np.random.default_rng(seed)
    bits = np.concatenate([rng.integers(0, 2, 114, dtype=np.uint8), np.zeros(6, np.uint8)])
    coded = tinav.conv_encode(bits)
    coded[rng.choice(coded.size, 4, replace=False)] ^= 1
    noise = rng.integers(0, 2, 240, dtype=np.uint8)
    for symbols in (coded, noise):
        got, want = trxd.viterbi_decode(symbols, 120), jrxd.viterbi_decode(symbols, 120)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(trxd.viterbi_decode(coded, 120), bits)


@pytest.mark.parametrize("word_type", [0, 1, 2, 3, 4, 5, 6])
def test_page_decode_and_word_parse_match(word_type):
    """A page pair of PRN 10 from the port's I/NAV encoder, framed, with
    two seeded symbol errors in each half page: both decoders give the
    same page and CRC verdict, both parsers the same fields."""
    nav, g0, ephs = _fixture_ephemerides()
    even, odd = tinav.generate_page_pair(g0, ephs[10], nav.iono, word_type)
    symbols = np.concatenate([tinav.frame_half_page(even), tinav.frame_half_page(odd)])
    rng = np.random.default_rng(word_type)
    for half in (0, 250):
        symbols[half + 10 + rng.choice(240, 2, replace=False)] ^= 1
    got, want = trxd.decode_page_pair(symbols), jrxd.decode_page_pair(symbols)
    for f in dataclasses.fields(jrxd.DecodedPage):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert got.crc_ok and got.word_type == word_type
    fields = tpvt.parse_word(tpvt.page_content(got))
    assert fields == jpvt.parse_word(jpvt.page_content(want))
    assert fields["word_type"] == word_type


def test_assemble_ephemeris_matches():
    nav, g0, ephs = _fixture_ephemerides()
    for prn, eph in ephs.items():
        words = {}
        for wt in (1, 2, 3, 4, 5):
            even, odd = tinav.generate_page_pair(g0, eph, nav.iono, wt)
            page = trxd.decode_page_pair(
                np.concatenate([tinav.frame_half_page(even), tinav.frame_half_page(odd)]))
            words[wt] = tpvt.parse_word(tpvt.page_content(page))
        got = tpvt.assemble_ephemeris(words, g0.week, prn)
        want = jpvt.assemble_ephemeris(words, g0.week, prn)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), prn
        assert got.svid == prn and abs(got.sqrta - eph.sqrta) <= 2.0**-19


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pvt_matches(seed):
    """Pseudoranges of the fixture scene's satellites at the fixture site
    (the port's forward model) with seeded metre-level errors: both
    solvers give the same solution, near the truth."""
    from galileo_sdr_sim_tpu_torch.constants import D2R, SPEED_OF_LIGHT
    from galileo_sdr_sim_tpu_torch.geodesy import llh2xyz
    from galileo_sdr_sim_tpu_torch.rinex import EphArrays

    nav, g0, ephs = _fixture_ephemerides()
    eph_list = list(ephs.values())
    truth = llh2xyz(np.array([LLH[0] * D2R, LLH[1] * D2R, LLH[2]]))
    t_rx = g0.sec + 5.0
    rho = compute_range(EphArrays.from_records(eph_list), nav.iono, g0.week,
                        np.full(len(eph_list), t_rx), truth).range
    rng = np.random.default_rng(seed)
    t_tx = t_rx - (rho + rng.normal(0.0, 2.0, rho.size)) / SPEED_OF_LIGHT
    got = tpvt.solve_pvt(eph_list, t_tx, nav.iono, g0.week)
    want = jpvt.solve_pvt(eph_list, t_tx, nav.iono, g0.week)
    assert np.array_equal(got.xyz, want.xyz) and got.t_rx == want.t_rx
    assert np.array_equal(got.residuals, want.residuals) and got.prns == want.prns
    assert np.linalg.norm(got.xyz - truth) < 30.0
