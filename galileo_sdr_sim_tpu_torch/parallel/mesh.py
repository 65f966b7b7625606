"""Rank-mesh sharding of the synthesis engines over torch.distributed.

Port of galileo_sdr_sim_tpu/parallel/mesh.py.  The JAX package lays a
(sat, time) device mesh under one program (`shard_map`); here each rank
is a process of its own with one device, and the mesh is the set of
process groups its collectives run over.  The two axes are the
workload's two parallel axes:

* 'sat': channels are split in contiguous blocks; each rank computes the
  float32 partial I/Q of its channels and the partials are summed by
  `dist.all_reduce` over the rank's sat group before truncation to
  int16: the JAX `lax.psum` (mesh.py:154-156), the reference's per-sample
  `i_acc += ip` as a collective.  The factorized engine's partial comes
  from the kernel's f32 emit (ops/synth_kp_cuda.synth_kp_accum).
* 'time': epochs (factorized engine) or sample tiles (direct engine) are
  split in contiguous blocks; they need no communication, since the
  host seeds every shard with exact float64 phases.  The whole block is
  all-gathered over the rank's time group at the end, so that every rank
  returns what `np.asarray` of the JAX global array returns.

Rank r sits at time = r // n_sat, sat = r % n_sat.  The psum reassociates
the float32 channel sum, so a sharded output may differ from the
single-device one by 1 LSB on a few samples (PSUM_* bounds in the JAX
package's parallel/distributed.py); under `lut512` every product and sum
is a small integer, and the sharded direct engine is exact.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..constants import NUM_IQ_SAMPLES
from ..convert import kp_shard
from ..ops.synth import TILE, prepare_device_inputs, synth_accum
from ..ops.synth_kp import P_GRID, packed_to_iq16, prepare_kp_inputs
from ..ops.synth_kp_cuda import synth_kp_accum
from ..scenario import EpochBatch


@dataclass(frozen=True)
class RankMesh:
    """This rank's place in a (time, sat) mesh of n_time x n_sat ranks and
    the groups it communicates over."""

    n_sat: int
    n_time: int
    sat: int
    time: int
    device: torch.device
    sat_group: object  # the ranks of this time row: channel partials summed
    time_group: object  # the ranks of this sat column: epoch shards gathered

    @property
    def shape(self) -> dict:
        return {"sat": self.n_sat, "time": self.n_time}


def check_placements(placements: list, n_sat: int, n_time: int, backend: str) -> None:
    """`placements[r]` = (host, device) of rank r.  NCCL cannot run two
    ranks of one communicator on one GPU; raise ValueError when two ranks
    of one sat or time group hold the same GPU under NCCL (gloo runs
    them, CUDA tensors included)."""
    if backend != "nccl":
        return
    groups = [("sat", [t * n_sat + s for s in range(n_sat)]) for t in range(n_time)]
    groups += [("time", [t * n_sat + s for t in range(n_time)]) for s in range(n_sat)]
    for axis, ranks in groups:
        seen = {}
        for r in ranks:
            host, device = placements[r]
            if not device.startswith("cuda"):
                continue
            if (host, device) in seen:
                raise ValueError(
                    f"ranks {seen[(host, device)]} and {r} of one {axis} group both hold "
                    f"{device} on {host}: NCCL cannot run two ranks on one GPU; give "
                    "each rank its own GPU, or initialize with backend='gloo'"
                )
            seen[(host, device)] = r


def gather_objects(obj) -> list:
    """`obj` of every rank, in rank order, through a gloo group (no NCCL
    collective runs before the placements are checked)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=dist.new_group(backend="gloo"))
    return out


def make_mesh(n_sat: int, n_time: int, device: torch.device) -> RankMesh:
    """The (time, sat) mesh over the initialized world, this rank on
    `device`.  Collective: every rank calls it with the same shape, and
    every rank creates every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (parallel/distributed.py)")
    world = dist.get_world_size()
    if world != n_sat * n_time:
        raise ValueError(f"world of {world} ranks is not a ({n_time} time, {n_sat} sat) mesh")
    placements = gather_objects((socket.gethostname(), str(device)))
    check_placements(placements, n_sat, n_time, dist.get_backend())
    time_i, sat_i = divmod(dist.get_rank(), n_sat)
    sat_group = time_group = None
    for t in range(n_time):
        group = dist.new_group([t * n_sat + s for s in range(n_sat)])
        if t == time_i:
            sat_group = group
    for s in range(n_sat):
        group = dist.new_group([t * n_sat + s for t in range(n_time)])
        if s == sat_i:
            time_group = group
    return RankMesh(n_sat, n_time, sat_i, time_i, device, sat_group, time_group)


def _gather_rows(local: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Concatenate every time shard's `local` along dim 0, on every rank."""
    parts = [torch.empty_like(local) for _ in range(mesh.n_time)]
    dist.all_gather(parts, local, group=mesh.time_group)
    return torch.cat(parts)


def _words(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) int32 packed words (a view): collectives
    move int32, which every backend takes."""
    return iq.view(torch.int32).squeeze(-1)


# --- factorized (K, p) engine (the production path) ----------------------


def shard_kp_inputs(inputs: dict, mesh: RankMesh) -> dict:
    """This rank's shard of the prepared kernel operands, each contiguous
    (the kernel takes contiguous operands): `convert.kp_shard` at the
    rank's mesh position."""
    local = kp_shard(inputs, mesh.n_sat, mesh.n_time, mesh.sat, mesh.time)
    return {k: v.contiguous() for k, v in local.items()}


def sharded_kp_step(local: dict, mesh: RankMesh, n_k: int) -> torch.Tensor:
    """One rank's step of the sharded factorized engine (the JAX
    `sharded_kp_fn` body): the f32 partial of its channels (kernel 2 on
    a GPU, its plain version on the CPU), summed over the sat group,
    truncated -> (B_local, n_k*1300, 2) int16."""
    with torch.inference_mode():
        acc = synth_kp_accum(local, n_k)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.sat_group)
        return torch.trunc(acc).to(torch.int16)


def synth_batch_kp_sharded(
    batch: EpochBatch,
    mesh: RankMesh,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
) -> np.ndarray:
    """Sharded production path: batch -> (B, 2*nsamples) int16 numpy,
    the whole block on every rank.  Channels stay uncompacted when the
    sat axis splits them (as in the JAX package); the CBOC weights, when
    the model has them, are replicated to every rank."""
    inputs = prepare_kp_inputs(
        batch, nsamples, pad_epochs=pad_epochs, code_cache=code_cache,
        device=mesh.device, compact=mesh.n_sat == 1,
    )
    B, C = inputs["cp0"].shape
    if C % mesh.n_sat or B % mesh.n_time:
        raise ValueError(f"(B={B}, C={C}) do not split over the mesh {mesh.shape}")
    iq = sharded_kp_step(shard_kp_inputs(inputs, mesh), mesh, nsamples // P_GRID)
    with torch.inference_mode():
        whole = _gather_rows(_words(iq), mesh)  # (B, n_k*1300) int32
    return packed_to_iq16(whole.cpu().numpy())[:, : 2 * nsamples]


# --- direct engine ---------------------------------------------------------


def shard_inputs(inputs: dict, mesh: RankMesh) -> dict:
    """This rank's shard of the direct engine's operands
    (ops/synth.prepare_device_inputs), cut as the JAX `shard_inputs`
    specs: codes P("sat", None), (B, C) P(None, "sat"), tile bases
    P(None, "sat", "time"), symbol windows P(None, "sat", None)."""
    C, nt = inputs["cp_base"].shape[1:]
    if C % mesh.n_sat or nt % mesh.n_time:
        raise ValueError(f"(C={C}, tiles={nt}) do not split over the mesh {mesh.shape}")
    cs, ts = C // mesh.n_sat, nt // mesh.n_time
    chans = slice(mesh.sat * cs, (mesh.sat + 1) * cs)
    tiles = slice(mesh.time * ts, (mesh.time + 1) * ts)
    local = {}
    for name, value in inputs.items():
        if name in ("codes_b", "codes_c"):
            local[name] = value[chans]
        elif name in ("cp_base", "w_base", "carr_base"):
            local[name] = value[:, chans, tiles]
        else:
            local[name] = value[:, chans]
    return {k: v.contiguous() for k, v in local.items()}


def synth_batch_sharded(
    batch: EpochBatch,
    mesh: RankMesh,
    tile: int = TILE,
    mode: str = "float",
    nsamples: int = NUM_IQ_SAMPLES,
) -> np.ndarray:
    """The direct engine under the mesh: channels over 'sat', sample tiles
    over 'time' -> (B, 2*nsamples) int16 numpy on every rank."""
    inputs = prepare_device_inputs(batch, tile, nsamples, device=mesh.device)
    local = shard_inputs(inputs, mesh)
    with torch.inference_mode():
        acc = synth_accum(
            local["codes_b"], local["codes_c"], local["a"], local["fc"],
            local["cp_base"], local["w_base"], local["carr_base"],
            local["sym_win"], local["pilot_win"], tile=tile, mode=mode,
        )  # (B, tiles_local, T, 2)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.sat_group)
        words = _words(torch.trunc(acc).to(torch.int16))  # (B, tiles_local, T)
        whole = _gather_rows(words.transpose(0, 1).contiguous(), mesh).transpose(0, 1)
    out = whole.contiguous().cpu().numpy().view(np.int16)
    return out.reshape(out.shape[0], -1)[:, : 2 * nsamples]
