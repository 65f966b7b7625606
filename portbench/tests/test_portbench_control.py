"""The comparison that decides `correct` has to fail what is wrong.

* The control: the plain reference in the program's place, one precision
  step below the configuration's (the carrier and channel sum in
  bfloat16), on a checked epoch of each configuration at its real size,
  fails the configuration's limits; and, band-limited, the filter's
  history reset to zero at a block's edge fails `max_abs` on the epoch
  that starts the block.
* The faults: a run driven on the CPU (the chip's look skipped, the
  program's plain engines) with the timed path broken underneath comes
  out not correct, for each fault a file-generation cell can have: the
  scenario's step (`ScenarioEngine._step_block`, its one stepping path)
  returns its state unchanged; half of each block left
  out of what the sink gets; one nav symbol altered where the scenario
  makes it.  (There is no exchange between chips: every cell takes one;
  and at one epoch a block, as in traffic/file_b1.json, a block has no half.)
"""

from __future__ import annotations

import pytest
import torch

from galileo_sdr_sim_tpu_torch.io import stream
from galileo_sdr_sim_tpu_torch.scenario import ScenarioEngine
from portbench.harness.check import epoch_numbers, reference_epochs
from portbench.harness.jobs import draw_job
from portbench.harness.spec import ROOT, load_cell, read_files

from test_portbench_run import cpu_line, tiny_cell

CPU = torch.device("cpu")


def with_config(cell, config: str):
    """The cell run with another configuration's file (e1_cboc_bl has no
    cell of its own in BENCHMARK.json yet; PERF.md §7)."""
    cell.config = read_files(config, "file_b8")[0]
    return cell


@pytest.mark.parametrize("config", ["e1_os", "e1_cboc_bl"])
def test_control_fails_the_limits(config):
    c = with_config(load_cell("e1_os.file_b8"), config)
    job = draw_job(c.traffic, 11, 0, seconds=3.0)
    epochs = [min(job.check)]
    nav = str(ROOT / c.config["nav_file"])
    ref = reference_epochs(job, epochs, c.config, nav, CPU)
    ctl = reference_epochs(job, epochs, c.config, nav, CPU, torch.bfloat16,
                           c.config["bandlimit"])
    off1, dense, _ = epoch_numbers(ctl[epochs[0]], ref[epochs[0]])
    limits = c.config["checks"]
    assert dense > 10 * limits["dense_pct"]
    if "off1_pct" in limits:
        assert off1 > 10 * limits["off1_pct"]


def test_history_reset_fails_max_abs():
    """The filter's history zero at the edge of a block: the epoch that
    starts it moves by more than the limit (PERF.md gives the readings at
    the cell's size on the card)."""
    c = with_config(load_cell("e1_os.file_b8"), "e1_cboc_bl")
    job = draw_job(c.traffic, 11, 0, seconds=3.0)
    b = c.traffic["block_epochs"]
    edge = [e for e in job.check if e > 0 and e % b == 0]
    assert len(edge) == 1
    nav = str(ROOT / c.config["nav_file"])
    ref = reference_epochs(job, edge, c.config, nav, CPU)
    ctl = reference_epochs(job, edge, c.config, nav, CPU, reset_every=b)
    _, dense, max_abs = epoch_numbers(ctl[edge[0]], ref[edge[0]])
    assert max_abs > 2 * c.config["checks"]["max_abs"]
    assert dense <= c.config["checks"]["dense_pct"]  # what dense_pct alone cannot see


def _stuck_step(orig):
    def step(self, iumd0, m):
        grx = self.grx
        tabs = orig(self, iumd0, m)
        self.grx = grx  # the scene's time never advances
        return tabs
    return step


def _altered_symbol_step(orig):
    def step(self, iumd0, m):
        tabs = orig(self, iumd0, m)
        for tab in tabs:
            c = int((tab.prn > 0).argmax())
            tab.sym_win = tab.sym_win.copy()
            tab.sym_win[c, 5] = -tab.sym_win[c, 5]  # the sixth 4 ms symbol of a channel
        return tabs
    return step


def _half_drain(orig):
    def drain(self, batch, fut, n_real):
        return orig(self, batch, fut, max(1, n_real // 2))
    return drain


FAULTS = {
    "state_unchanged": (ScenarioEngine, "_step_block", _stuck_step),
    "half_the_block": (stream.StreamingSynthesizer, "_drain", _half_drain),
    "symbol_altered": (ScenarioEngine, "_step_block", _altered_symbol_step),
}
CONFIGS = {
    "e1_os": dict(seconds=4.0, job_seconds=3.0),
    # band-limited on the CPU: two epochs a block, or a block takes minutes
    "e1_cboc_bl": dict(seconds=10.0, block_epochs=2, job_seconds=0.4, check_head_seconds=0.2),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(config, fault, monkeypatch):
    over = dict(CONFIGS[config])
    seconds = over.pop("seconds")
    cell = with_config(tiny_cell("e1_os.file_b8", **over), config)
    owner, attr, wrap = FAULTS[fault]
    monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    line = cpu_line(cell, seconds=seconds, seed=3)
    assert line["correct"] is False
    assert line["checks"]["checked_epochs"]["value"] >= 1
