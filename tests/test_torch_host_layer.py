"""The port's own host layer against the JAX package's, on the CPU.

The port keeps a copy of each JAX-free module of the reference it needs
(RINEX reader, scenario engine and what it stands on, signal models,
sinks, noise, the receiver's acquisition stage, the CLI's parser and
helpers), so that it imports nothing of the JAX package.  Each copy is
held to its original here with exact equality (`==`, `np.array_equal`):
they are the same code, so no tolerance applies.  The scenario cases
walk the fixture scene at B = 8 epochs a block: 60 s of the default
sine-BOC model (two 30 s I/NAV subframes, which between them carry every
word type, the fec2 Reed-Solomon pages included), and 30 s of CBOC,
without ionosphere, with the dummy almanac, and with a user-motion
trajectory that jumps (a channel reallocation at the 30 s boundary and a
block outside the kp engine's code-Doppler envelope).  The checkpoint
copy writes the same snapshot as its original, and a snapshot the JAX
package wrote resumes in the port; the receiver's decode and PVT copies
(`rx`, `rx_pvt`) give their originals' results on pages of the fixture
nav file made by the port's I/NAV encoder, with seeded symbol errors,
and on seeded pseudoranges."""

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


def _step(engine, blocks: int) -> None:
    gen = engine.batches(8)
    for _ in range(blocks):
        next(gen)


@pytest.mark.parametrize("case, blocks, drained", [
    ("e1", 3, None), ("e1", 3, 8), ("cboc", 2, 8), ("motion_jump", 20, 144),
])
def test_checkpoint_snapshots_match(case, blocks, drained, tmp_path):
    """Each package's save_state on its own engine after the same blocks
    (with `drained`, rewound to that epoch through the replay ring, as a
    pipelined run's snapshot is) writes the same JSON and npz arrays."""
    engines = _engines(case, tmp_path)
    for engine, ckpt, name in zip(engines, (jckpt, tckpt), ("jax", "port")):
        engine._replay_keep = 32
        _step(engine, blocks)
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
