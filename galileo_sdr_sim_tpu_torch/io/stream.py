"""Streaming executor of the PyTorch port: scenario blocks -> device
synthesis -> sink.

Port of galileo_sdr_sim_tpu/io/stream.py.  At pipeline depth 1 (the
default) one thread prepares and dispatches block k+1, then drains
block k, so the device computes k+1 while the host writes k.  At depth
>= 2 a producer thread prepares and dispatches up to `pipeline_depth`
blocks ahead of the draining thread, through a bounded queue.  On a GPU
each block's result is copied into a pinned host buffer on the stream
its kernel ran on, right after the kernel is enqueued; the drain waits
for that copy's event.  With `drain_host=False` the sink receives the
device tensor itself (no copy to the host).  With a `checkpoint_path`
the scenario state at the last drained epoch is saved every
`checkpoint_every` epochs (checkpoint.py), and a run whose snapshot
exists resumes after it.

Routing per block, as the JAX executor does:
* the factorized kp engine (ops/synth_kp_cuda.synth_kp_packed: the CUDA
  kernel on a GPU, its plain PyTorch version on the CPU), for the
  sine-BOC and the CBOC signal models, with `apply_gain` weighting each
  channel;
* under `bandlimit` (CBOC only), one kp call of the block's 12
  phase-shifted copies and the polyphase filter (ops/bandlimit.py), its
  overlap state carried across blocks;
* the direct engine (ops/synth.py), one epoch at a time, for blocks with
  an epoch outside the kp engine's code-Doppler envelope (MU_MAX).  As
  in the JAX executor, such a block ignores `apply_gain` and, under
  `bandlimit`, is emitted pointwise and leaves the filter state as it
  was (docs/bandlimit.md, known seams);
* the direct engine for every block under `mode='lut512'`, and for
  signal models other than the sine-BOC and CBOC ones.

Timing: `run` installs the run's Timer on each thread it runs
(profiling.installed).  The stages are its top-level spans: `scenario`,
`host_prep+dispatch` (`fallback_direct` for a direct-engine block),
`device_wait+fetch` and `sink_write`.  The layers below open theirs
inside them: `scenario/geometry`, `/nav_page`, `/realloc` and `/pack`
(scenario.py); `host_prep+dispatch/seed`, `/codes` (a window-table
rebuild) and `/h2d` (ops/synth_kp.py), `/launch` and `/fetch` (here);
`sink_write/file` (io/sinks.FileSink).  A stage's section includes its
spans'.  Under torch.profiler the innermost open span of a thread holds
a range of its path, so a stage's ranges are its self time; with no
profiler running no range opens.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from ..checkpoint import load_state, save_state
from ..constants import NUM_IQ_SAMPLES
from ..ops.bandlimit import initial_state, synth_block_cboc_bandlimited
from ..ops.synth import TILE, prepare_device_inputs, synth_block
from ..ops.synth_kp import P_GRID, ROWS, mu_in_envelope, packed_to_iq16, prepare_kp_inputs
from ..ops.synth_kp_cuda import synth_kp_packed
from ..profiling import Timer, installed, span
from ..scenario import EpochStateTable, ScenarioEngine
from .sinks import Sink


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


class _Fetch:
    """A device block on its way to the host: on a GPU, a pinned host
    buffer filled by a non-blocking copy and the event that marks its
    end; on the CPU, the block itself."""

    def __init__(self, block: torch.Tensor):
        with span("fetch"):
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
        checkpoint_every: int = 300,
        apply_gain: bool = False,
        pipeline_depth: int | None = None,
        drain_host: bool = True,
        bandlimit: bool = False,
    ):
        if synth_engine not in ("auto", "kp", "kp_pallas", "direct"):
            raise ValueError(f"unknown synthesis engine {synth_engine!r}")
        if mode not in ("float", "lut512"):
            raise ValueError(f"unknown carrier mode {mode!r}")
        self.engine = engine
        self.sink = sink
        self.device = device
        self.mode = mode
        # the factorized engine needs whole (8 x 1300)-sample row cycles,
        # implements the float carrier only, and takes the sine-BOC
        # half-chip tables and the 12-grid CBOC tables (code_subdiv 2, 12)
        subdiv = getattr(engine.model, "code_subdiv", 2)
        use_kp = (
            synth_engine != "direct"
            and nsamples % (ROWS * P_GRID) == 0
            and mode != "lut512"
            and subdiv in (2, 12)
        )
        self.synth_engine = "kp" if use_kp else "direct"
        self.apply_gain = apply_gain
        self.bandlimit = bandlimit
        if bandlimit:
            if subdiv != 12:
                raise ValueError(
                    "--bandlimit needs the CBOC signal model "
                    "(models/cboc.py); run with --model cboc"
                )
            if self.synth_engine != "kp":
                raise ValueError(
                    "--bandlimit requires the factorized (K,p) engines "
                    f"(got {self.synth_engine})"
                )
            self._bl_state = initial_state(device)
        self.tile = tile
        self.block_epochs = block_epochs
        self.nsamples = nsamples  # != NUM_IQ_SAMPLES only in tests
        self.status_cb = status_cb
        self.stats = StreamStats(timer=Timer())
        # device blocks in flight ahead of the sink: depth 1 is the
        # single-thread prepare(k+1)-then-drain(k) loop, in which a live
        # position update lands in the next prepared epoch; depth >= 2
        # adds a producer thread with bounded-queue backpressure
        self.pipeline_depth = max(1, pipeline_depth or 1)
        # drain_host=False: the sink receives each block as a tensor on
        # `device` (no copy to the host); fallback blocks stay numpy
        self.drain_host = drain_host
        # serializes scenario stepping (the producer thread) against the
        # checkpoint snapshots taken on the draining thread
        self._engine_lock = threading.Lock()
        self._stop = False
        self._code_cache: dict = {}
        self._direct_cache: dict = {}  # the direct engine's code slabs
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every  # epochs between snapshots
        self._start_epoch = 1
        if checkpoint_path is not None:
            # a snapshot rewinds to the last DRAINED epoch while the
            # producer runs up to pipeline_depth + 1 blocks ahead: the
            # engine's replay ring must cover those in-flight epochs
            engine._replay_keep = (self.pipeline_depth + 2) * block_epochs
            if Path(checkpoint_path).with_suffix(".json").exists():
                # under bandlimit the filter's overlap state restarts at
                # zeros here, as in the JAX executor (docs/bandlimit.md)
                self._start_epoch = load_state(engine, checkpoint_path) + 1

    def stop(self) -> None:
        self._stop = True

    def _hand_over(self, block: torch.Tensor):
        """A block as it leaves the producer: on its way to the host
        (`_Fetch`), or the device tensor itself when the sink takes it."""
        return _Fetch(block) if self.drain_host else block

    def _device_blocks(self) -> Iterator[tuple[object, object, int]]:
        gen = self.engine.batches(self.block_epochs, start=self._start_epoch)
        while True:
            # scenario stepping (host float64 geometry and nav bits) has
            # its own stage: the JAX executor leaves it untimed.  It runs
            # under the engine lock, so a snapshot sees committed state
            with span("scenario"):
                with self._engine_lock:
                    batch = next(gen, None)
            if batch is None:
                return
            n_real = batch.f_code.shape[0]
            use_kp = self.synth_engine == "kp"
            fallback = use_kp and not mu_in_envelope(batch.f_code)
            # the fallback synthesizes and synchronizes on the host, so it
            # gets its own stage, as in the JAX executor
            section = "fallback_direct" if fallback else "host_prep+dispatch"
            with span(section):
                if use_kp and not fallback and self.bandlimit:
                    out, self._bl_state = synth_block_cboc_bandlimited(
                        batch,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._code_cache,
                        state=self._bl_state,
                        apply_gain=self.apply_gain,
                        device=self.device,
                    )
                    fut = self._hand_over(out)
                elif use_kp and not fallback:
                    inputs = prepare_kp_inputs(
                        batch,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._code_cache,
                        device=self.device,
                        apply_gain=self.apply_gain,
                    )
                    with span("launch"):
                        out = synth_kp_packed(inputs, n_k=self.nsamples // P_GRID)
                    fut = self._hand_over(out)
                elif fallback:
                    # an epoch's code Doppler left the kp envelope (a live
                    # position teleport or a reallocation transition):
                    # the direct engine is exact for any rate; one epoch
                    # at a time bounds its memory.  Like the JAX
                    # executor's, it applies no gain, and under bandlimit
                    # the block bypasses the filter, whose state it leaves
                    # untouched
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
                    fut = self._hand_over(synth_block(inputs, tile=self.tile, mode=self.mode))
            yield batch, fut, n_real

    def run(self) -> StreamStats:
        """Drain the blocks in order until the scenario ends or stop() is
        called: at depth 1 dispatch block k+1, then drain block k, on this
        thread; at depth >= 2 a producer thread dispatches up to
        `pipeline_depth` blocks ahead.  The run's Timer is installed on
        both threads (profiling.installed; disjoint section names), so
        the sum of its stages can exceed the wall time."""
        t0 = time.perf_counter()
        with installed(self.stats.timer):
            if self.pipeline_depth == 1:
                pending = None
                for item in self._device_blocks():
                    if pending is not None:
                        self._drain(*pending)
                    pending = item
                    if self._stop:
                        break
                if pending is not None:
                    self._drain(*pending)
            else:
                self._run_threaded()
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    def _run_threaded(self) -> None:
        q: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        err: list[BaseException] = []
        done = threading.Event()
        # a new thread starts on device 0: keep the producer's kernels,
        # copies and events on this run's device
        on_device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                     else contextlib.nullcontext())

        def produce() -> None:
            # put() polls with a short timeout only so that stop() can end
            # a wait on a full queue; 2 ms bounds the dead time a handoff
            # can add in steady state
            try:
                with on_device, installed(self.stats.timer):
                    for item in self._device_blocks():
                        while not self._stop:
                            try:
                                q.put(item, timeout=0.002)
                                break
                            except queue.Full:
                                continue
                        if self._stop:
                            return
            except BaseException as e:  # re-raised on the draining thread
                err.append(e)
            finally:
                # completion travels beside the queue: an Event never
                # blocks, where a sentinel would need a free slot
                done.set()

        th = threading.Thread(target=produce, name="stream-producer")
        th.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.01)
                except queue.Empty:
                    if err or (done.is_set() and q.empty()):
                        break
                    continue
                self._drain(*item)
                if self._stop:
                    break
        finally:
            self._stop = True
            th.join()
        if err:
            raise err[0]

    def _drain(self, batch, fut, n_real: int) -> None:
        if self.drain_host:
            with span("device_wait+fetch"):
                host = fut.result() if isinstance(fut, _Fetch) else fut
                if host.ndim == 3:  # packed int32 I/Q -> free int16 view
                    host = packed_to_iq16(host)
                host = host[:n_real, : 2 * self.nsamples]
            with span("sink_write"):
                self.sink.write(host)
        else:
            # the device-resident sink decides its own synchronization
            # point.  kp blocks keep the packed int32 (B, n_k, 1300)
            # layout, the band-limited and direct ones (B, 2 nsamples)
            # int16; a block is sliced only when it is partial
            with span("sink_write"):
                shape = tuple(fut.shape)
                if len(shape) == 3:
                    self.sink.write(fut if shape[0] == n_real else fut[:n_real])
                elif shape == (n_real, 2 * self.nsamples):
                    self.sink.write(fut)
                else:
                    self.sink.write(fut[:n_real, : 2 * self.nsamples])
        self.stats.epochs += n_real
        self.stats.samples += n_real * self.nsamples
        if self.status_cb is not None:
            self.status_cb(batch, self.stats)
        if (
            self.checkpoint_path is not None
            and self.stats.epochs % self.checkpoint_every < n_real
        ):
            # under the engine lock: the producer must not step the
            # scenario mid-snapshot.  drained_iumd rewinds the snapshot to
            # what the sink has received, so a resume replays the blocks
            # still in flight instead of skipping them
            with self._engine_lock:
                save_state(
                    self.engine,
                    self.checkpoint_path,
                    drained_iumd=self._start_epoch - 1 + self.stats.epochs,
                )
