"""The readers of the band-limited cell's spans on a hand-built
Observation: each is its section's seconds as a share of the window,
nothing where the program has no such span (a parent without it, or a
cell whose path does not open it), and within its parent section's
share."""

from __future__ import annotations

import pytest

from portbench.harness.main import Observation, read_metric
from portbench.harness.spec import load_cell

CELL = "e1_cboc_bl.file_b8"
# reader -> (its section, the reader of the section that includes it)
SPANS = {
    "bl_filter_share_pct": ("host_prep+dispatch/filter", "host_prep_share_pct"),
    "scenario_pack_codes_share_pct": ("scenario/pack/codes", "scenario_pack_share_pct"),
}
LAYERS = {"bl_filter_share_pct": "Host prep + dispatch",
          "scenario_pack_codes_share_pct": "Scenario"}

# a 40 s window of the band-limited stream; each section holds its spans
SECTIONS = {
    "scenario": 20.0, "scenario/pack": 16.5, "scenario/pack/codes": 16.25,
    "scenario/geometry": 1.5, "host_prep+dispatch": 17.5,
    "host_prep+dispatch/seed": 9.0, "host_prep+dispatch/launch": 2.25,
    "host_prep+dispatch/filter": 1.125, "device_wait+fetch": 0.0625, "sink_write": 2.0,
}


def observation(sections: dict) -> Observation:
    return Observation(load_cell(CELL), 9.0, 40.0, 10**9, dict(sections), None)


def _entry(name: str) -> dict:
    return next(m for m in load_cell(CELL).per_layer if m["name"] == name)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_is_its_section_over_the_window(name):
    section, parent = SPANS[name]
    o = observation(SECTIONS)
    got = read_metric(_entry(name), o)
    assert got == pytest.approx(100.0 * SECTIONS[section] / 40.0)
    assert 0 < got <= read_metric(_entry(parent), o)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_finds_nothing_without_its_section(name):
    section, parent = SPANS[name]
    o = observation({k: v for k, v in SECTIONS.items() if k != section})
    assert read_metric(_entry(name), o) is None
    assert read_metric(_entry(parent), o) is not None


def test_manifest_entries_of_the_cell():
    """The configuration, the cell and its three per-layer entries, each
    listed for the cell and moving samples_per_s."""
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.config["bandlimit"] and cell.config["model"] == "cboc"
    names = {m["name"] for m in cell.per_layer}
    for name in (*SPANS, "bl_filter_roofline_pct"):
        assert name in names
        m = _entry(name)
        assert m["workloads"] == [CELL] and m["moves"] == "samples_per_s" and m["unit"] == "%"
    for name, layer in LAYERS.items():
        m = _entry(name)
        assert (m["source"], m["better"], m["layer"]) == ("program_span", "lower", layer)
    m = _entry("bl_filter_roofline_pct")
    assert (m["source"], m["better"], m["layer"]) == ("device_trace", "higher",
                                                      "Band-limit filter")
