"""BENCHMARK.json against the benchmark's files: every entry resolves by
name to its configuration, traffic mix and metric reader, and the file
keeps the shape the harness and the contract read."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness.spec import BENCH, ROOT, load_cell

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    assert len({e["name"] for e in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}) == \
        len(MANIFEST["end_to_end"]) + len(MANIFEST["per_layer"])


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    path = ROOT / config["file"]
    assert path.parent == BENCH / "configs" and path.stem == config["name"]
    body = json.loads(path.read_text())
    for key in config["reduced"]:
        assert key in body and key in body["source_values"]
    assert (ROOT / body["nav_file"]).is_file()
    assert body["nav_file"].startswith("portbench/")
    assert "dense_pct" in body["checks"] and body["checks"]["missing_epochs"] == 0


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    c = load_cell(cell["name"])
    assert c.chips == cell["chips"] == 1
    assert c.traffic["block_epochs"] >= 1 and c.traffic["job_seconds"] > 0
    assert {"samples_per_s", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_each_config_and_bound():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
