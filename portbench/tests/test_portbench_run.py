"""A run end to end on the CPU at a tiny size (jobs of a second, the
program's plain PyTorch engines): the result line's keys, the check, the
JAX check by top-level module name; and, where a card is, a run of the
real entry point."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench.harness import main as harness
from portbench.harness.spec import ROOT, load_cell

SEED = 2**31 + 12345


def tiny_cell(name: str, **traffic):
    """The cell with jobs short enough for the CPU."""
    cell_ = load_cell(name)
    cell_.traffic.update(job_seconds=1.0, warmup_seconds=0.3, check_head_seconds=0.3)
    cell_.traffic.update(traffic)
    return cell_


def cpu_line(cell, seconds=3.0, trace=False, seed=SEED) -> dict:
    out = harness.measure(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
    return harness.report(cell, out, trace, {"platform": "cpu", "kind": "cpu", "count": 1})


def test_sound_run_is_correct_and_its_line_has_the_keys():
    line = cpu_line(tiny_cell("e1_os.file_b8"))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    assert line["checks"]["checked_epochs"]["value"] >= 1
    assert line["checks"]["dense_pct"]["value"] == 0.0
    assert line["checks"]["off1_pct"]["value"] < line["checks"]["off1_pct"]["limit"]
    json.dumps(line)


def test_traced_line_has_the_per_layer_metrics():
    line = cpu_line(tiny_cell("e1_os.file_b8"), trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    # no device on the CPU: the trace's readers find nothing to read
    assert set(line["metrics"]) == {
        "scenario_share_pct", "host_prep_share_pct", "drain_share_pct", "sink_share_pct",
        "device_idle_pct", "scenario_geometry_share_pct", "scenario_nav_share_pct",
        "scenario_pack_share_pct", "scenario_pack_codes_share_pct", "host_prep_seed_share_pct",
        "host_prep_launch_share_pct", "host_prep_fetch_share_pct", "sink_file_share_pct"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_blocked_modules_by_top_level_name(monkeypatch):
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "galileo_sdr_sim_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "galileo_sdr_sim_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert harness.blocked_modules() == ["galileo_sdr_sim_tpu", "jaxlib"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    run fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "e1_os.file_b8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.cuda
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "e1_os.file_b8",
                           "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
