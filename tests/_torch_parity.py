"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed or from the in-repo
fixture nav file, go through the JAX package and the port; both see
identical float32 operands.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import torch

from galileo_sdr_sim_tpu.models.e1 import E1_OS
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.scenario import ScenarioEngine
from galileo_sdr_sim_tpu_torch import harness

NAV = Path(__file__).resolve().parent / "data" / "obs_fixture_nav.rnx"
DIST_WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
RANKS_TIMEOUT_S = 300  # a hung rendezvous fails its test, not the whole run
START = harness.FIXTURE_START
LLH = harness.FIXTURE_LLH
CPU = torch.device("cpu")

# the test run is several pytest-xdist worker processes at once; torch's
# default of one OpenMP thread per core in each of them oversubscribes
# the cores, and the spinning threads slow the run several times over
torch.set_num_threads(min(2, torch.get_num_threads()))


def fixture_engine(duration_s: float, model=E1_OS) -> ScenarioEngine:
    return harness.fixture_engine(NAV, duration_s, model=model)


def fixture_batch(block_epochs: int = 8, model=E1_OS):
    return next(fixture_engine(1.0, model=model).batches(block_epochs))


def synthetic_pair(B: int, C: int, seed: int, case: str, **variant) -> tuple:
    """-> (jax_inputs, torch_inputs) holding the same seeded operands;
    `variant` is harness.synthetic_operands' cboc= and gain=."""
    host, codes_b, codes_c = harness.synthetic_operands(B, C, seed, case, **variant)
    jax_inputs = {k: jnp.asarray(v) for k, v in host.items()}
    jax_inputs["vpack"] = jnp.asarray(jkp._pack_codes(codes_b, codes_c))
    jax_inputs["vpack_rs"] = jnp.asarray(jkp._pack_codes_rs(codes_b, codes_c))
    return jax_inputs, harness.synthetic_kp_inputs(B, C, seed, case, CPU, **variant)


def run_ranks(mode: str, world: int, outdir: Path) -> None:
    """Run `world` ranks of tests/_torch_dist_worker.py in `mode`, gloo on
    the CPU, meeting through a file in `outdir`; raise unless every rank
    ends well within RANKS_TIMEOUT_S."""
    (outdir / "static.csv").write_text(",".join(str(v) for v in LLH) + "\n")
    init = f"file://{outdir / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(DIST_WORKER), mode, init, str(world), str(rank), str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    try:
        outs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK {rank} OK" not in out:
            raise RuntimeError(f"rank {rank} of {mode} failed (rc {p.returncode}):\n{out[-3000:]}")
