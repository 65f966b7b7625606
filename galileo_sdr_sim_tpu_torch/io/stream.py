"""Streaming executor of the PyTorch port: scenario blocks -> device
synthesis -> host sink.

Port of galileo_sdr_sim_tpu/io/stream.py at pipeline depth 1: block k+1
is prepared and dispatched, then block k is drained, so the device
computes k+1 while the host writes k.  On a GPU each block's result is
copied into a pinned host buffer on the device's stream right after the
kernel is enqueued; the drain waits for that copy's event.

Routing per block, as the JAX executor does:
* the factorized kp engine (ops/synth_kp_cuda.synth_kp_packed: the CUDA
  kernel on a GPU, its plain PyTorch version on the CPU);
* the direct engine (ops/synth.py), one epoch at a time, for blocks with
  an epoch outside the kp engine's code-Doppler envelope (MU_MAX);
* the direct engine for every block under `mode='lut512'`.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES
from galileo_sdr_sim_tpu.io.sinks import Sink
from galileo_sdr_sim_tpu.profiling import Timer
from galileo_sdr_sim_tpu.scenario import EpochStateTable, ScenarioEngine

from ..ops.synth import TILE, prepare_device_inputs, synth_block
from ..ops.synth_kp import P_GRID, ROWS, mu_in_envelope, packed_to_iq16, prepare_kp_inputs
from ..ops.synth_kp_cuda import synth_kp_packed


def _slice_epoch(batch, e: int):
    """One-epoch view of an EpochBatch (epoch axis sliced to [e:e+1];
    channel-map fields pass through)."""
    return dataclasses.replace(
        batch,
        grx_sec=batch.grx_sec[e : e + 1],
        f_carr=batch.f_carr[e : e + 1],
        f_code=batch.f_code[e : e + 1],
        code_phase0=batch.code_phase0[e : e + 1],
        carr_phase0=batch.carr_phase0[e : e + 1],
        sym_win=batch.sym_win[e : e + 1],
        pilot_win=batch.pilot_win[e : e + 1],
        gain=batch.gain[e : e + 1],
    )


@dataclass
class StreamStats:
    epochs: int = 0
    samples: int = 0
    wall_s: float = 0.0
    # per-stage wall-clock split (host prep/dispatch, device wait, sink)
    timer: Timer | None = None

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.wall_s if self.wall_s else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.samples_per_sec / 2.6e6

    def stage_report(self) -> str:
        return self.timer.report() if self.timer else ""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch engine yet ({item})")


class _Fetch:
    """A device block on its way to the host: on a GPU, a pinned host
    buffer filled by a non-blocking copy and the event that marks its
    end; on the CPU, the block itself."""

    def __init__(self, block: torch.Tensor):
        if block.device.type == "cuda":
            self._host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
            self._host.copy_(block, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(block.device))
        else:
            self._host, self._event = block, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class StreamingSynthesizer:
    """Drives a ScenarioEngine epoch by epoch into a Sink on `device`."""

    def __init__(
        self,
        engine: ScenarioEngine,
        sink: Sink,
        *,
        device: torch.device,
        mode: str = "float",
        synth_engine: str = "auto",
        tile: int = TILE,
        block_epochs: int = 8,
        nsamples: int = NUM_IQ_SAMPLES,
        status_cb: Callable[[EpochStateTable, StreamStats], None] | None = None,
        checkpoint_path: str | None = None,
        apply_gain: bool = False,
        pipeline_depth: int | None = None,
        drain_host: bool = True,
        bandlimit: bool = False,
    ):
        if pipeline_depth is not None and pipeline_depth > 1:
            raise _not_ported("pipeline_depth > 1", "ROADMAP queue 1 item 5")
        if checkpoint_path is not None:
            raise _not_ported("checkpointing", "ROADMAP queue 1 item 5")
        if not drain_host:
            raise _not_ported("drain_host=False", "ROADMAP queue 1 item 5")
        if bandlimit:
            raise _not_ported("--bandlimit", "ROADMAP queue 1 item 9")
        if getattr(engine.model, "code_subdiv", 2) != 2:
            raise _not_ported("the CBOC signal model", "ROADMAP queue 1 item 8")
        if apply_gain:
            raise _not_ported("--apply-gain", "ROADMAP queue 1 item 8")
        if synth_engine not in ("auto", "kp", "kp_pallas", "direct"):
            raise ValueError(f"unknown synthesis engine {synth_engine!r}")
        if mode not in ("float", "lut512"):
            raise ValueError(f"unknown carrier mode {mode!r}")
        self.engine = engine
        self.sink = sink
        self.device = device
        self.mode = mode
        # the factorized engine needs whole (8 x 1300)-sample row cycles
        # and implements the float carrier only
        use_kp = (
            synth_engine != "direct"
            and nsamples % (ROWS * P_GRID) == 0
            and mode != "lut512"
        )
        self.synth_engine = "kp" if use_kp else "direct"
        self.tile = tile
        self.block_epochs = block_epochs
        self.nsamples = nsamples  # != NUM_IQ_SAMPLES only in tests
        self.status_cb = status_cb
        self.stats = StreamStats(timer=Timer())
        self._stop = False
        self._code_cache: dict = {}
        self._direct_cache: dict = {}  # the direct engine's code slabs

    def stop(self) -> None:
        self._stop = True

    def _device_blocks(self) -> Iterator[tuple[object, object, int]]:
        gen = self.engine.batches(self.block_epochs)
        while True:
            # scenario stepping (host float64 geometry and nav bits) has
            # its own stage: the JAX executor leaves it untimed
            with self.stats.timer.section("scenario"):
                batch = next(gen, None)
            if batch is None:
                return
            n_real = batch.f_code.shape[0]
            use_kp = self.synth_engine == "kp"
            fallback = use_kp and not mu_in_envelope(batch.f_code)
            # the fallback synthesizes and synchronizes on the host, so it
            # gets its own stage, as in the JAX executor
            section = "fallback_direct" if fallback else "host_prep+dispatch"
            with self.stats.timer.section(section):
                if use_kp and not fallback:
                    inputs = prepare_kp_inputs(
                        batch,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._code_cache,
                        device=self.device,
                    )
                    fut = _Fetch(synth_kp_packed(inputs, n_k=self.nsamples // P_GRID))
                elif fallback:
                    # an epoch's code Doppler left the kp envelope (a live
                    # position teleport or a reallocation transition):
                    # the direct engine is exact for any rate; one epoch
                    # at a time bounds its memory
                    outs = []
                    for e in range(n_real):
                        dinp = prepare_device_inputs(
                            _slice_epoch(batch, e),
                            self.tile,
                            self.nsamples,
                            pad_epochs=1,
                            code_cache=self._direct_cache,
                            device=self.device,
                        )
                        block = synth_block(dinp, tile=self.tile, mode=self.mode)
                        outs.append(block[:, : 2 * self.nsamples].cpu().numpy())
                    fut = np.concatenate(outs, axis=0)
                else:
                    inputs = prepare_device_inputs(
                        batch,
                        self.tile,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._direct_cache,
                        device=self.device,
                    )
                    fut = _Fetch(synth_block(inputs, tile=self.tile, mode=self.mode))
            yield batch, fut, n_real

    def run(self) -> StreamStats:
        """Dispatch block k+1, then drain block k, until the scenario ends
        or stop() is called."""
        t0 = time.perf_counter()
        pending = None
        for item in self._device_blocks():
            if pending is not None:
                self._drain(*pending)
            pending = item
            if self._stop:
                break
        if pending is not None:
            self._drain(*pending)
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    def _drain(self, batch, fut, n_real: int) -> None:
        with self.stats.timer.section("device_wait+fetch"):
            host = fut.result() if isinstance(fut, _Fetch) else fut
            if host.ndim == 3:  # packed int32 I/Q -> free int16 view
                host = packed_to_iq16(host)
            host = host[:n_real, : 2 * self.nsamples]
        with self.stats.timer.section("sink_write"):
            self.sink.write(host)
        self.stats.epochs += n_real
        self.stats.samples += n_real * self.nsamples
        if self.status_cb is not None:
            self.status_cb(batch, self.stats)
