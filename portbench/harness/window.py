"""The measured window: file-generation jobs back to back through the
program's streaming executor, as its command line runs them with
`-U 1 -b 1` (file sink, no bit relay), until the window closes.

Each job builds the program's `ScenarioEngine` and `StreamingSynthesizer`.
A static job's position source is live and stays at the job's site, as
the command line's UDP position thread leaves it, without the sockets; a
moving job's is its trajectory, as `-u` gives it.  The sink is
the program's `FileSink` on `os.devnull` behind `TeeSink`.  The tee
passes every block on unchanged, counts the samples handed over while the
window is open, keeps the epochs the check compares, and stops the job's
stream at the close.  The nav file is parsed once, in set-up, with the
ionosphere model off where the configuration says `"iono": false`, as
`-I` turns it off.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
from torch.profiler import record_function

from galileo_sdr_sim_tpu_torch.cli import _parse_time
from galileo_sdr_sim_tpu_torch.io.sinks import FileSink
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch.models.e1 import E1_OS
from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3
from galileo_sdr_sim_tpu_torch.scenario import (
    PositionProvider, ScenarioEngine, scenario_start_time,
)

from .jobs import Job, draw_job, epochs_of


class Window:
    """`seconds` of wall clock from `open()`, and the samples handed to the
    sink while it is open."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t_close = None
        self.samples = 0

    def open(self) -> None:
        self.t_close = time.perf_counter() + self.seconds

    def is_open(self) -> bool:
        return time.perf_counter() < self.t_close


class TeeSink:
    """Between the program's stream and its FileSink."""

    def __init__(self, sink, window: Window | None, keep: frozenset):
        self.sink, self.window, self.keep = sink, window, keep
        self.epochs = 0  # epochs handed over, in order
        self.kept: dict[int, np.ndarray] = {}
        self.stop = None  # the stream's stop(), set once it exists
        self.timer = None  # its Timer
        self.sections_at_close = None  # the Timer's sections when the window closed

    def write(self, iq: np.ndarray) -> None:
        if self.window is None or self.window.is_open():
            if self.window is not None:
                self.window.samples += iq.shape[0] * (iq.shape[1] // 2)
            for e in self.keep:
                if self.epochs <= e < self.epochs + iq.shape[0]:
                    self.kept[e] = np.array(iq[e - self.epochs])
        elif self.sections_at_close is None:
            self.sections_at_close = dict(self.timer.sections)
            self.stop()
        self.epochs += iq.shape[0]
        self.sink.write(iq)

    def close(self) -> None:
        self.sink.close()


@dataclass
class JobResult:
    job: Job
    expected: int  # epochs the job emits when it runs to its end
    epochs: int = 0  # epochs handed to the sink
    finished: bool = False  # ran to its end inside the window
    error: str | None = None
    satellites: int = 0  # channels allocated at the job's start
    sections: dict = field(default_factory=dict)  # its Timer's, up to the close
    counts: dict = field(default_factory=dict)
    kept: dict = field(default_factory=dict)


class Runner:
    """The nav file parsed and the signal model chosen, once; `job()` runs
    one job.  It builds the engine and stream as the program's command
    line does (`cli.build_engine`: `--bandlimit` implies `--model cboc`;
    `cli.build_run`: the StreamingSynthesizer with the defaults `--mode
    float` and `--engine auto`), by hand, since `cli.build_engine` opens
    the live-position UDP servers on fixed ports."""

    def __init__(self, config: dict, traffic: dict, root, device):
        self.model = E1_CBOC if config["model"] == "cboc" or config["bandlimit"] else E1_OS
        self.config, self.traffic, self.device = config, traffic, device
        self.nav = read_rinex_v3(str(root / config["nav_file"]))
        if not config.get("iono", True):
            self.nav.iono.enable = False

    def job(self, job: Job, window: Window | None) -> JobResult:
        res = JobResult(job, epochs_of(job.seconds))
        tee = None
        try:
            with record_function("portbench.job_setup"):
                if job.trajectory is None:
                    llh = np.asarray(job.llh, np.float64)
                    position = PositionProvider(live=lambda: llh)
                else:
                    position = PositionProvider(trajectory=job.trajectory)
                engine = ScenarioEngine(
                    self.nav, position,
                    scenario_start_time(self.nav, _parse_time(job.start_arg)), job.seconds,
                    model=self.model,
                )
                res.satellites = sum(ch.prn > 0 for ch in engine.bank.channels)
                tee = TeeSink(FileSink(os.devnull), window, job.check)
                synth = StreamingSynthesizer(
                    engine, tee, device=self.device, mode="float", synth_engine="auto",
                    block_epochs=self.traffic["block_epochs"],
                    pipeline_depth=self.traffic["pipeline_depth"],
                    apply_gain=self.config["apply_gain"], bandlimit=self.config["bandlimit"],
                )
                tee.stop, tee.timer = synth.stop, synth.stats.timer
            synth.run()
            res.finished = tee.sections_at_close is None
            timer = synth.stats.timer
            res.sections = tee.sections_at_close or dict(timer.sections)
            res.counts = dict(timer.counts)
        except Exception:  # a job that raises is a failed job; the run goes on
            res.error = traceback.format_exc()
            sys.stderr.write(f"job {job.index} failed:\n{res.error}")
        finally:
            if tee is not None:
                tee.close()
                res.epochs, res.kept = tee.epochs, tee.kept
        return res


def run_window(runner: Runner, window: Window, seed: int) -> list:
    """Jobs back to back until the window closes -> their JobResults."""
    results = []
    window.open()
    with record_function("portbench.window"):
        while window.is_open():
            results.append(runner.job(draw_job(runner.traffic, seed, len(results)), window))
    return results
