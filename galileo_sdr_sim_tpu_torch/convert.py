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

from galileo_sdr_sim_tpu.scenario import EpochBatch

from .ops.synth_kp import kernel_operands, operands_to_device


def kp_inputs_from_jax(np_inputs: dict, device: torch.device) -> dict:
    """The JAX package's `prepare_kp_inputs(..., pack_g=True)` dict, each
    value passed through `np.asarray`, -> the port's kernel operands on
    `device` (window anchors and bit-packed symbol words derived here,
    as the JAX Pallas wrapper derives them)."""
    for key in ("cboc_ab", "chan_gain"):
        if key in np_inputs:
            raise NotImplementedError(
                f"operand {key!r}: CBOC and per-channel gain are not ported "
                "yet (ROADMAP queue 1 item 8)"
            )
    if "vpack_rs" not in np_inputs:
        raise ValueError("prepare the JAX inputs with pack_g=True (needs vpack_rs)")
    out = operands_to_device(kernel_operands(np_inputs), device)
    out["vpack_rs"] = torch.from_numpy(
        np.array(np_inputs["vpack_rs"], dtype=np.int8)  # writable copy
    ).to(device)
    return out


def batch_to_device(batch: EpochBatch, device: torch.device) -> dict:
    """Every array field of an `EpochBatch` as a tensor on `device`, dtype
    unchanged (float64 seeds stay float64)."""
    return {
        f.name: torch.from_numpy(np.ascontiguousarray(getattr(batch, f.name))).to(device)
        for f in dataclasses.fields(batch)
    }
