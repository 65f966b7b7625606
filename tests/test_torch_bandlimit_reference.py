"""The port's band-limited CBOC stream against the benchmark's plain
reference (portbench/reference), on the CPU.

The port runs as the command line's `--model cboc --bandlimit` and the
benchmark's jobs run it: a live position source at the fixture site,
`StreamingSynthesizer(bandlimit=True)` over the CBOC model, blocks of 2
epochs, three blocks, so that the filter's history crosses two block
edges.  The reference steps the same scene in its own frozen host layer
(static receiver) and works each epoch out in float64: the twelve phase
streams, each truncated to int16, then the 385-tap filter from its
definition, its history taken from the epoch before (zero at the job's
start).  The two are compared epoch by epoch on the interleaved int16
values, by two limits:

* `max_abs`, the largest |difference|.  The phase streams differ from the
  reference's by the chip-edge class: where the kernel's float32 code
  phase puts a sample on the other side of a sub-chip edge than float64
  does, that phase sample moves by up to `BAR_MAX_DIFF` = 1000 (the
  largest seen here: 954).  The filter weighs one phase sample by at
  most max|K| = 0.0834 (K the polyphase kernel), so one such sample moves
  an output by up to 83.  A 33-sample window of the twelve streams holds
  about one of them here (most at the BOC(6,1) edges, of at most ~300),
  so the limit is two of the largest at the kernel's peak tap, plus the
  filter's trunc slack: 2 * 1000 * 0.0834 + 2 = 168.  Measured: 98.
* `dense_pct`, the benchmark's own check (portbench/harness/check.py): the
  share of 50 us stretches whose median |difference| exceeds 1 LSB, under
  the configuration's limit (1%).  The chip-edge differences are sparse
  and leave every stretch's median at 0 or 1.  Measured: 0.

Three faults each fail the comparison: the filter's history reset to
zeros at a block edge (max_abs 1085: the first ~20 outputs of the block
lose the tail of the last), two adjacent phase streams swapped (dense
100%), and the benchmark's control precision (portbench/control.py: the
reference with its carrier and channel sum in bfloat16; the control's
TF32 filter is a GPU precision, so here its filter runs in float32;
dense 96%).  The benchmark's check alone misses the first: its dense
reading stays 0.

Small sizes: 20800-sample epochs (n_k = 16; the reference's epoch length
set to match), so each epoch's history is the last 32 samples of the
20800 the epoch before emitted, as the port's is."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu_torch import cli, scenario
from galileo_sdr_sim_tpu_torch.harness import BAR_MAX_DIFF, BL_SLACK
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch.ops import bandlimit
from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3
from portbench.harness.check import epoch_numbers, reference_epochs
from portbench.harness.jobs import Job
from portbench.reference import synth

from _torch_parity import CPU, LLH, NAV, START
from conftest import CollectSink

CONFIG = json.loads(
    (Path(__file__).resolve().parents[1] / "portbench" / "configs" / "e1_cboc_bl.json").read_text())
NS = 16 * 1300  # samples an epoch
BLOCK = 2  # epochs a block
SECONDS = 0.7  # 6 epochs: three blocks
EPOCHS = 6
MAX_DIFF = int(2 * BAR_MAX_DIFF * np.abs(bandlimit.polyphase_kernel()).max() + BL_SLACK)
DENSE_PCT = CONFIG["checks"]["dense_pct"]
SWAPPED = (5, 6)  # the adjacent phase streams of the swap fault


def _job() -> Job:
    day, clock = START.split(",")
    start = (*map(int, day.split("/")), *map(int, clock.split(":")))
    return Job(0, LLH, start, SECONDS, frozenset(range(EPOCHS)))


def _reference(monkeypatch, mix_dtype=torch.float64, filter_tf32=False) -> np.ndarray:
    """(EPOCHS, 2 NS) int16 of the plain reference at NS samples an epoch."""
    monkeypatch.setattr(synth, "SAMPLES", NS)
    refs = reference_epochs(_job(), list(range(EPOCHS)), CONFIG, str(NAV), CPU,
                            mix_dtype, filter_tf32)
    return np.stack([refs[e] for e in range(EPOCHS)])


def _port() -> np.ndarray:
    """(EPOCHS, 2 NS) int16 of the port's band-limited stream, built as the
    benchmark's jobs build it."""
    nav = read_rinex_v3(str(NAV))
    llh = np.array(LLH, np.float64)
    engine = scenario.ScenarioEngine(
        nav, scenario.PositionProvider(live=lambda: llh),
        scenario.scenario_start_time(nav, cli._parse_time(START)), SECONDS, model=E1_CBOC)
    sink = CollectSink()
    StreamingSynthesizer(engine, sink, device=CPU, mode="float", synth_engine="auto",
                         block_epochs=BLOCK, nsamples=NS, pipeline_depth=1,
                         bandlimit=True).run()
    assert [b.shape[0] for b in sink.blocks] == [BLOCK] * (EPOCHS // BLOCK)
    return np.concatenate(sink.blocks)


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    """Worst `max_abs` and `dense_pct` over the epochs, and whether both
    hold their limits."""
    assert got.shape == ref.shape == (EPOCHS, 2 * NS) and got.dtype == ref.dtype == np.int16
    max_abs = int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())
    dense = max(epoch_numbers(g, r)[1] for g, r in zip(got, ref))
    return {"max_abs": max_abs, "dense_pct": dense,
            "ok": max_abs <= MAX_DIFF and dense <= DENSE_PCT}


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        return _reference(mp)


def test_limits_follow_the_kernel_and_the_configuration():
    assert MAX_DIFF == 168 and DENSE_PCT == 1.0
    assert CONFIG["model"] == "cboc" and CONFIG["bandlimit"] and not CONFIG["apply_gain"]


def test_stream_matches_the_plain_reference(reference):
    got = compare(_port(), reference)
    assert got["ok"], got


@pytest.mark.parametrize("fault", ["history_reset", "phases_swapped", "control_precision"])
def test_fault_fails_the_comparison(fault, reference, monkeypatch):
    if fault == "history_reset":
        filter_block, calls = bandlimit.filter_block, []

        def reset(stacked, hist, n_real):
            calls.append(n_real)
            if len(calls) == 2:  # the edge between the first two blocks
                hist = torch.zeros_like(hist)
            return filter_block(stacked, hist, n_real)

        monkeypatch.setattr(bandlimit, "filter_block", reset)
        got = _port()
    elif fault == "phases_swapped":
        synth_phases = bandlimit.synth_phases

        def swapped(*args, **kwargs):
            x = synth_phases(*args, **kwargs).clone()
            x[list(SWAPPED)] = x[list(SWAPPED[::-1])]
            return x

        monkeypatch.setattr(bandlimit, "synth_phases", swapped)
        got = _port()
    else:
        got = _reference(monkeypatch, torch.bfloat16, filter_tf32=True)
    result = compare(got, reference)
    assert not result["ok"], result
