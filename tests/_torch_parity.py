"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed or from the in-repo
fixture nav file, go through the JAX package and the port; both see
identical float32 operands.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import torch

from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.scenario import ScenarioEngine
from galileo_sdr_sim_tpu_torch import harness

NAV = Path(__file__).resolve().parent / "data" / "obs_fixture_nav.rnx"
START = harness.FIXTURE_START
LLH = harness.FIXTURE_LLH
CPU = torch.device("cpu")


def fixture_engine(duration_s: float) -> ScenarioEngine:
    return harness.fixture_engine(NAV, duration_s)


def fixture_batch(block_epochs: int = 8):
    return next(fixture_engine(1.0).batches(block_epochs))


def synthetic_pair(B: int, C: int, seed: int, case: str) -> tuple:
    """-> (jax_inputs, torch_inputs) holding the same seeded operands."""
    host, codes_b, codes_c = harness.synthetic_operands(B, C, seed, case)
    jax_inputs = {k: jnp.asarray(v) for k, v in host.items()}
    jax_inputs["vpack"] = jnp.asarray(jkp._pack_codes(codes_b, codes_c))
    jax_inputs["vpack_rs"] = jnp.asarray(jkp._pack_codes_rs(codes_b, codes_c))
    return jax_inputs, harness.synthetic_kp_inputs(B, C, seed, case, CPU)
