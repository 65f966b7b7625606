"""A cell, found by its name: its entry in BENCHMARK.json, its
configuration file (`configs/<config>.json`), its traffic file
(`traffic/<traffic>.json`), and the metrics it reports."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def _reports(metric: dict, e2e_names: set) -> bool:
    """Whether a cell reports `metric`: an end-to-end metric, every cell;
    a per-layer metric, every cell that reports the end-to-end metric it
    moves.  A reader that finds nothing to read in a cell returns None and
    the metric is left out of that cell's line."""
    return "moves" not in metric or metric["moves"] in e2e_names


def read_files(config: str, traffic: str) -> tuple:
    """(configuration, traffic mix) dicts from their files."""
    return (json.loads((BENCH / "configs" / f"{config}.json").read_text()),
            json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config, traffic = read_files(entry["config"], entry["traffic"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, e2e_names)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer)
