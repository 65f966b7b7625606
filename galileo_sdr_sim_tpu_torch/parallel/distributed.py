"""Multi-process file generation over torch.distributed.

Port of galileo_sdr_sim_tpu/parallel/distributed.py.  Every process runs
the same deterministic ScenarioEngine (host state follows from the RINEX
file, the start time and the position), synthesizes its (time, sat)
shard of every block on its own device, and the sat-index-0 rank of
each time row offset-writes its epochs into the shared file, which rank
0 has sized first.

Launch: set, on every process, the three variables the JAX package
reads and run the same command line, one process per GPU:

    GALILEO_COORDINATOR=host:port  (or an init_method URL, e.g. file://...)
    GALILEO_NUM_PROCESSES=N  GALILEO_PROCESS_ID=0..N-1

The backend is NCCL for CUDA devices and gloo for the CPU; a caller may
pass backend="gloo" with CUDA tensors (gloo takes them).  The mesh is the
JAX package's "one time row per process, its local devices the sat
axis" with one rank per device: the ranks of one host form the sat axis
(their channel partials summed by all_reduce), the hosts the time axis.

As in the JAX package, this path has no MU_MAX fallback (every epoch
goes through the factorized engine), drops the CBOC weights (the model's
sign banks are synthesized without alpha +- beta*tau; distributed.py
:109-111, :149 there), and applies neither gain nor the band limit.
"""

from __future__ import annotations

import datetime
import os
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..constants import NUM_IQ_SAMPLES
from ..ops.synth_kp import P_GRID, prepare_kp_inputs
from ..profiling import Timer
from .mesh import RankMesh, gather_objects, make_mesh, shard_kp_inputs, sharded_kp_step

ENV_COORD = "GALILEO_COORDINATOR"
ENV_NPROC = "GALILEO_NUM_PROCESSES"
ENV_PID = "GALILEO_PROCESS_ID"

# The accumulation-order bound for psum'd synthesis, stated once.
#
# A psum over the 'sat' axis associates the float32 channel additions
# differently from the single-device sequential/tree reduction, so the
# int16 truncation `(short)i_acc` (galileo-sdr.cpp:536) can flip a
# sample by exactly 1 LSB where the accumulator lands on an integer
# boundary.  Empirically < 0.1% of samples across the test scenarios,
# never more than 1 LSB — hence: at least this fraction of samples must
# be bit-identical, and no sample may differ by more than PSUM_MAX_LSB.
# This is a float-association property, not nondeterminism: the lut512
# direct engine under the same mesh is asserted exactly equal
# (tests/test_sharding.py), and any single layout is reproducible.
PSUM_SAMPLE_IDENTITY_BOUND = 0.999
PSUM_MAX_LSB = 1

# a rendezvous or collective that waits longer than this fails instead of
# hanging the job
DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator: str, num_processes: int, process_id: int, backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group: `coordinator` is host:port (TCP) or an
    init_method URL; the backend defaults to NCCL where CUDA is
    available, else gloo."""
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )


def maybe_initialize_from_env(backend: str | None = None) -> bool:
    """Join a process group if GALILEO_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID
    are set (returns True), else stay single-process (False)."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    initialize(coord, int(os.environ[ENV_NPROC]), int(os.environ[ENV_PID]), backend)
    return True


def host_layout(hosts: list) -> tuple:
    """Host name of every rank, in rank order -> (n_time, n_sat): each
    host's ranks form one time row.  They must be contiguous, and every
    host must hold the same count."""
    rows = []
    for rank, host in enumerate(hosts):
        if not rows or rows[-1][0] != host:
            if any(h == host for h, _ in rows):
                raise ValueError(f"rank {rank}: the ranks of host {host} are not contiguous")
            rows.append((host, 0))
        rows[-1] = (host, rows[-1][1] + 1)
    counts = {n for _, n in rows}
    if len(counts) != 1:
        raise ValueError(f"hosts hold unequal rank counts: {rows}")
    return len(rows), counts.pop()


def global_mesh(device_type: str = "cuda") -> RankMesh:
    """(time, sat) mesh over the whole world: one time row per host, its
    ranks the sat axis.  A rank's device is cuda:(local index % device
    count), or the CPU."""
    n_time, n_sat = host_layout(gather_objects(socket.gethostname()))
    local = dist.get_rank() % n_sat
    if device_type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)  # the device NCCL's barrier uses
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    return make_mesh(n_sat, n_time, device)


def synth_batch_kp_distributed(
    batch, nsamples: int, mesh: RankMesh | None = None, code_cache: dict | None = None,
    timer: Timer | None = None,
) -> list:
    """Multi-process production path.  Every process passes the SAME
    EpochBatch; returns this rank's (epoch_index, iq_rows) segments,
    epoch-major int16 (n, 2*nsamples) pieces ready for offset writes:
    the time shard of the sat-index-0 rank, nothing on the others.
    `timer` (optional) gets the stages host_prep, synth+all_reduce (the
    kernel launch and the collective; on the CPU the plain version's
    compute) and device_wait+fetch."""
    mesh = mesh if mesh is not None else global_mesh()
    timer = timer if timer is not None else Timer()
    B_real = batch.f_code.shape[0]
    # pad partial batches (cut early at channel-map changes) up to a
    # multiple of the time axis; padded epochs are trimmed from segments
    pad = -(-B_real // mesh.n_time) * mesh.n_time
    with timer.section("host_prep"):
        inputs = prepare_kp_inputs(
            batch, nsamples, pad_epochs=pad if pad != B_real else None, code_cache=code_cache,
            device=mesh.device, compact=mesh.n_sat == 1,
        )
        # the JAX distributed path shards no CBOC weights (reproduced)
        inputs.pop("cboc_ab", None)
        if inputs["cp0"].shape[1] % mesh.n_sat:
            raise ValueError(f"channels {inputs['cp0'].shape[1]} do not split over {mesh.n_sat} ranks")
        local = shard_kp_inputs(inputs, mesh)
    with timer.section("synth+all_reduce"):
        iq = sharded_kp_step(local, mesh, nsamples // P_GRID)
    with timer.section("device_wait+fetch"):
        e0 = mesh.time * iq.shape[0]
        if mesh.sat != 0 or e0 >= B_real:  # sat replicas, padding shards
            return []
        rows = iq[: B_real - e0]
        return [(e0, rows.reshape(rows.shape[0], -1)[:, : 2 * nsamples].cpu().numpy())]


def write_segments(path: str | Path, segments, nsamples: int,
                   base_epoch: int = 0) -> None:
    """Offset-write this process's epoch segments into the shared file.

    Process 0 must have pre-sized the file (see `presize`); every process
    then pwrites its own contiguous byte ranges — no locks needed since
    ranges are disjoint."""
    bytes_per_epoch = 2 * nsamples * 2  # int16 I/Q
    with open(path, "r+b") as fh:
        for e0, rows in segments:
            fh.seek((base_epoch + e0) * bytes_per_epoch)
            fh.write(np.ascontiguousarray(rows, dtype=np.int16).tobytes())


def presize(path: str | Path, nsamples: int, total_epochs: int) -> None:
    with open(path, "wb") as fh:
        fh.truncate(total_epochs * 2 * nsamples * 2)


def barrier(name: str = "galileo") -> None:
    """Wait for every rank (`name` labels the call site)."""
    dist.barrier()


def generate_file_distributed(
    engine, outfile: str | Path, block_epochs: int = 8, nsamples: int | None = None,
    *, mesh: RankMesh | None = None, device_type: str = "cuda", timer: Timer | None = None,
) -> int:
    """Offline multi-process file generation: every process runs the same
    ScenarioEngine, synthesizes its shard of every batch and offset-writes
    the shared file.  Returns the number of epochs written.  `timer`
    (optional) gets the stage split: scenario, the three stages of
    `synth_batch_kp_distributed`, sink_write."""
    nsamples = nsamples or NUM_IQ_SAMPLES
    mesh = mesh if mesh is not None else global_mesh(device_type)
    timer = timer if timer is not None else Timer()
    if dist.get_rank() == 0:
        presize(outfile, nsamples, total_epochs=len(engine))
    barrier("presize")
    base, cache = 0, {}
    batches = engine.batches(block_epochs)
    while True:
        with timer.section("scenario"):
            batch = next(batches, None)
        if batch is None:
            break
        segs = synth_batch_kp_distributed(batch, nsamples, mesh, cache, timer)
        with timer.section("sink_write"):
            write_segments(outfile, segs, nsamples, base_epoch=base)
        base += batch.f_code.shape[0]
    barrier("written")
    return base
