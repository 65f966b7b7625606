"""The in-repo nav file tests/data/obs_fixture_nav.rnx (written by
tools/make_fixture_rinex.py from tests/data/obs_ref_fixture.json) gives
back every fixture field and a real scene for the port's tests."""

import importlib.util
import json
from pathlib import Path

import numpy as np

from galileo_sdr_sim_tpu.rinex import read_rinex_v3
from galileo_sdr_sim_tpu_torch.ops.synth_kp import mu_in_envelope

from _torch_parity import NAV, fixture_engine

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "obs_ref_fixture.json"


def _fixture():
    return json.loads(FIXTURE.read_text())


def test_every_fixture_field_read_back_exactly():
    fix = _fixture()
    nav = read_rinex_v3(NAV)
    assert len(fix["eph"]) == 25
    for sv_s, fields in fix["eph"].items():
        recs = nav.eph[int(sv_s)]
        assert len(recs) == 2, sv_s  # each record is written twice
        for rec in recs:
            for key, val in fields.items():
                if key == "toe_sec":
                    got = rec.toe.sec
                elif key == "toc_sec":
                    got = rec.toc.sec
                else:
                    got = getattr(rec, key)
                assert float(got) == val, (sv_s, key, got, val)
            assert rec.flag == 517
    for key, val in fix["iono_header"].items():
        got = nav.iono.vflg if key == "vflg" else getattr(nav.iono, key)
        assert float(got) == float(val), key


def test_time_window_has_an_end():
    gmin, gmax = read_rinex_v3(NAV).time_window()
    assert (gmin.week, gmin.sec) == (2197, 597600.0)
    assert (gmax.week, gmax.sec) == (2197, 603600.0)


def test_generator_reproduces_the_committed_file(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "make_fixture_rinex", REPO / "tools" / "make_fixture_rinex.py"
    )
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool, "OUT", tmp_path / "nav.rnx")
    monkeypatch.setattr(tool, "REPO", tmp_path)
    tool.main()
    assert (tmp_path / "nav.rnx").read_text() == NAV.read_text()


def test_fixture_scene_is_real_and_in_envelope():
    batches = list(fixture_engine(3.0).batches(8))
    assert sum(b.f_code.shape[0] for b in batches) == 29
    active = [int(p) for p in batches[0].prn if p > 0]
    assert len(active) >= 6, active
    for b in batches:
        assert np.array_equal(b.prn, batches[0].prn)
        assert mu_in_envelope(b.f_code)
