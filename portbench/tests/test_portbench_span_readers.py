"""The readers of the stream's spans below its stages (the Timer sections
`<stage>/<span>`) on a hand-built Observation: each is its section's
seconds as a share of the window, nothing where the program has no such
span, and within its stage's share, since a stage's section includes its
spans'."""

from __future__ import annotations

import pytest

from portbench.harness.main import Observation, read_metric
from portbench.harness.spec import load_cell

SPANS = {
    "scenario_geometry_share_pct": ("scenario/geometry", "scenario_share_pct"),
    "scenario_nav_share_pct": ("scenario/nav_page", "scenario_share_pct"),
    "scenario_pack_share_pct": ("scenario/pack", "scenario_share_pct"),
    "host_prep_seed_share_pct": ("host_prep+dispatch/seed", "host_prep_share_pct"),
    "host_prep_launch_share_pct": ("host_prep+dispatch/launch", "host_prep_share_pct"),
    "host_prep_fetch_share_pct": ("host_prep+dispatch/fetch", "host_prep_share_pct"),
    "sink_file_share_pct": ("sink_write/file", "sink_share_pct"),
}

# a 20 s window; each stage holds its spans, and a little of its own
SECTIONS = {
    "scenario": 14.0, "scenario/geometry": 7.0, "scenario/nav_page": 1.5,
    "scenario/pack": 0.5, "scenario/realloc": 0.25,
    "host_prep+dispatch": 2.5, "host_prep+dispatch/seed": 1.0,
    "host_prep+dispatch/codes": 0.0625, "host_prep+dispatch/h2d": 0.25,
    "host_prep+dispatch/launch": 0.5, "host_prep+dispatch/fetch": 0.375,
    "device_wait+fetch": 0.2, "sink_write": 3.0, "sink_write/file": 2.75,
}


def observation(sections: dict) -> Observation:
    return Observation(load_cell("e1_os.file_b8"), 7.0, 20.0, 10**9, dict(sections), None)


def _entry(name: str) -> dict:
    return next(m for m in load_cell("e1_os.file_b8").per_layer if m["name"] == name)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_is_its_section_over_the_window(name):
    section, _ = SPANS[name]
    assert read_metric(_entry(name), observation(SECTIONS)) == pytest.approx(
        100.0 * SECTIONS[section] / 20.0)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_finds_nothing_without_its_span(name):
    """A program without the span (the parent commit, or a cell whose
    path does not open it) leaves the metric out of the line."""
    section, stage = SPANS[name]
    stages_only = {k: v for k, v in SECTIONS.items() if "/" not in k}
    o = observation(stages_only)
    assert read_metric(_entry(name), o) is None
    assert read_metric(_entry(stage), o) is not None
    o.sections[section] = SECTIONS[section]
    assert read_metric(_entry(name), o) == pytest.approx(100.0 * SECTIONS[section] / 20.0)


def test_span_shares_sum_within_their_stage():
    o = observation(SECTIONS)
    got = {m["name"]: read_metric(m, o) for m in o.cell.per_layer}
    for stage in {s for _, s in SPANS.values()}:
        spans = [n for n, (_, s) in SPANS.items() if s == stage]
        assert 0 < sum(got[n] for n in spans) <= got[stage]


def test_span_entries_in_the_manifest():
    """Seven per-layer entries: program spans that move samples_per_s in
    the cells that report them, each under its stage's layer."""
    layers = {m["name"]: m["layer"] for m in load_cell("e1_os.file_b8").per_layer}
    for name, (_, stage) in SPANS.items():
        m = _entry(name)
        assert (m["source"], m["unit"], m["better"], m["moves"]) == (
            "program_span", "%", "lower", "samples_per_s")
        assert m["workloads"] == ["e1_os.file_b8", "e1_cboc_bl.file_b8"]
        assert m["layer"] == layers[stage]
