"""Carrying state across from the JAX package.

The simulator has no weights; what the two packages exchange is the
prepared per-block state: the JAX engine's operand dict and the host
`EpochBatch`.  These functions turn either into the port's tensors, so
a test can feed the very same operands to both engines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.synth_kp import kernel_operands, operands_to_device
from .scenario import EpochBatch


def kp_inputs_from_jax(np_inputs: dict, device: torch.device) -> dict:
    """The JAX package's `prepare_kp_inputs(..., pack_g=True)` dict, each
    value passed through `np.asarray`, -> the port's kernel operands on
    `device` (window anchors and bit-packed symbol words derived here,
    as the JAX Pallas wrapper derives them; `cboc_ab` and `chan_gain`
    carried across when present)."""
    if "vpack_rs" not in np_inputs:
        raise ValueError("prepare the JAX inputs with pack_g=True (needs vpack_rs)")
    out = operands_to_device(kernel_operands(np_inputs), device)
    out["vpack_rs"] = torch.from_numpy(
        np.array(np_inputs["vpack_rs"], dtype=np.int8)  # writable copy
    ).to(device)
    return out


def kp_shard(inputs: dict, n_sat: int, n_time: int, sat: int, time: int) -> dict:
    """One rank's (time, sat) shard of a kernel operand dict (the port's
    `prepare_kp_inputs` output, tensors or numpy), cut as the JAX
    package's `shard_kp_inputs` cuts its operands
    (galileo_sdr_sim_tpu/parallel/mesh.py:181-196): every (B, C) operand
    split `P("time", "sat")` in contiguous epoch and channel blocks,
    `vpack_rs` split `P("sat", None, None)`, `cboc_ab` replicated.
    Returns views (slices), not copies."""
    B, C = inputs["cp0"].shape
    if not (0 <= sat < n_sat and 0 <= time < n_time):
        raise ValueError(f"shard (time={time}, sat={sat}) outside a ({n_time}, {n_sat}) mesh")
    if B % n_time or C % n_sat:
        raise ValueError(f"(B={B}, C={C}) operands do not split over (time={n_time}, sat={n_sat})")
    rows = slice(time * (B // n_time), (time + 1) * (B // n_time))
    chans = slice(sat * (C // n_sat), (sat + 1) * (C // n_sat))
    out = {}
    for name, value in inputs.items():
        if name == "cboc_ab":
            out[name] = value
        elif name == "vpack_rs":
            out[name] = value[chans]
        else:
            out[name] = value[rows, chans]
    return out


def batch_to_device(batch: EpochBatch, device: torch.device) -> dict:
    """Every array field of an `EpochBatch` as a tensor on `device`, dtype
    unchanged (float64 seeds stay float64), copied: the code rows are
    read-only, shared by the batches of one channel map."""
    return {
        f.name: torch.from_numpy(np.array(getattr(batch, f.name), order="C")).to(device)
        for f in dataclasses.fields(batch)
    }
