"""The per-layer readers on synthetic Timer sections and a synthetic
Chrome trace, and the frozen work counts against the ones they froze."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from portbench.harness import roofline
from portbench.harness.main import Observation, read_metric
from portbench.harness.spec import ROOT, load_cell
from portbench.harness.trace import TraceSummary, reduce_events

MAIN = "void synth_kp_v5_kernel<{}, false, false>(float const*, int)"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def synthetic_trace(cboc="false"):
    """A 1000 us window: one kp pair (8 + 32 us), a 100 us copy, one
    conv1d whose launch starts a 500 us kernel, and the host's ranges."""
    return [
        _x("user_annotation", "portbench.window", 0, 1000),
        _x("user_annotation", "scenario", 0, 100),
        _x("user_annotation", "host_prep+dispatch", 100, 300),
        _x("user_annotation", "sink_write", 400, 600),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernelExC", 160, 5, correlation=2),
        _x("kernel", "kp_planes_kernel(float const*)", 200, 8, tid=7, correlation=1,
           grid=[13, 8, 8]),
        _x("kernel", MAIN.format(cboc), 204, 32, tid=7, correlation=2, grid=[11, 8, 5]),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 300, 100, tid=7, correlation=3),
        _x("cpu_op", "aten::conv1d", 240, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=4),
        _x("kernel", "implicit_convolve_sgemm", 450, 500, tid=7, correlation=4),
        _x("kernel", "outside_the_window", 1200, 10, tid=7, correlation=5),
    ]


def test_trace_reduction():
    t = reduce_events(synthetic_trace())
    assert t.window_s == pytest.approx(1e-3)
    # device busy: [200, 236] and [300, 400] and [450, 950]
    assert t.busy_s == pytest.approx((36 + 100 + 500) * 1e-6)
    assert [(c.B, c.C, c.cboc, c.gain) for c in t.kp_calls] == [(8, 8, False, False)]
    assert t.kp_calls[0].seconds == pytest.approx(40e-6)
    assert t.conv_calls == 1 and t.conv_seconds == pytest.approx(500e-6)
    # idle: 0-200 (scenario 100, prep 100), 236-300 and 400-450 (prep 64, sink 50), 950-1000
    assert t.idle_by_range["scenario"] == pytest.approx(100e-6)
    assert t.idle_by_range["host_prep+dispatch"] == pytest.approx(164e-6)
    assert t.idle_by_range["sink_write"] == pytest.approx(100e-6)
    assert reduce_events(synthetic_trace("true")).kp_calls[0].cboc
    assert reduce_events(synthetic_trace()[1:]) == TraceSummary()


def obs(cell_name="e1_os.file_b8", trace=True):
    cell = load_cell(cell_name)
    sections = {"scenario": 5.0, "host_prep+dispatch": 2.0, "device_wait+fetch": 0.5,
                "sink_write": 1.0}
    return Observation(cell, 7.0, 10.0, 123456789, sections,
                       reduce_events(synthetic_trace()) if trace else None)


def test_readers_on_synthetic_data():
    o = obs()
    cell = o.cell
    # the filter's reader waits for its cell (PERF.md §7); it reads a block of 8 epochs here
    entries = cell.end_to_end + cell.per_layer + [{"name": "bl_filter_roofline_pct"}]
    got = {m["name"]: read_metric(m, o) for m in entries}
    assert got["samples_per_s"] == pytest.approx(12345678.9)
    assert got["setup_s"] == 7.0
    assert got["scenario_share_pct"] == pytest.approx(50.0)
    assert got["host_prep_share_pct"] == pytest.approx(20.0)
    assert got["drain_share_pct"] == pytest.approx(5.0)
    assert got["sink_share_pct"] == pytest.approx(10.0)
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 636e-6 / 1e-3))
    assert got["kp_roofline_pct"] == pytest.approx(
        100 * roofline.kp_least_s(8, 8, False, False) / 40e-6)
    assert got["bl_filter_roofline_pct"] == pytest.approx(
        100 * roofline.filter_least_s(8) / 500e-6)


def test_readers_find_nothing_without_a_trace():
    o = obs(trace=False)
    for m in o.cell.per_layer + [{"name": "bl_filter_roofline_pct", "source": "device_trace"}]:
        if m["source"] == "device_trace":
            assert read_metric(m, o) is None
    o.sections.clear()
    assert all(read_metric(m, o) is None for m in o.cell.per_layer)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,C,cboc,gain", [(8, 8, False, False), (1, 8, False, False),
                                           (8, 8, True, False), (8, 16, True, True)])
def test_frozen_kp_count_matches_chip_smoke(B, C, cboc, gain):
    from galileo_sdr_sim_tpu_torch.ops.synth_kp import (
        GAIN_OPERAND, INT_OPERANDS, SCALAR_OPERANDS,
    )

    names = SCALAR_OPERANDS + ((GAIN_OPERAND,) if gain else ())
    inputs = {k: torch.zeros((B, C), dtype=torch.int32 if k in INT_OPERANDS else torch.float32)
              for k in names}
    if cboc:
        inputs["cboc_ab"] = torch.zeros(2)
    ms, _ = _chip_smoke().kp_bound(inputs, roofline.K_EPOCH)
    assert roofline.kp_least_s(B, C, cboc, gain) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_filter_count():
    # one block of 8 epochs: 216.32 MB in and out at 3.35 TB/s bounds it
    n = 8 * 260000
    nbytes = 4 * (12 * 2 * (n + 32) + 2 * n + 12 * 33)
    assert roofline.filter_least_s(8) == pytest.approx(nbytes / 3.35e12)
    assert 2 * 2 * 385 * n / 67e12 < nbytes / 3.35e12
