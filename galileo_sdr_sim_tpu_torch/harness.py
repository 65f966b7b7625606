"""Seeded synthetic operands for parity checks that need no RINEX file.

`synthetic_operands` makes, with numpy from a seed, the seeded float32
host operands of the factorized engine (the dict that
`prepare_kp_inputs` builds from an EpochBatch) plus real E1 code banks,
so the same inputs can go through the JAX engines, the plain PyTorch
version and the CUDA kernel.  The adversarial cases are those the JAX
package checks its Pallas kernel with (bench.py parity cases,
tests/test_synth_kp_pallas.py edge seeds).

`fixture_engine` is the real scene of the repository's fixture nav file
(tests/data/obs_fixture_nav.rnx): 2022-02-19 23:30:00 at Boston, 7
satellites in view, every epoch inside the factorized engine's envelope.

`engine_bar` is the parity bar the port is held to on the int16 values
of the packed output.
"""

from __future__ import annotations

import numpy as np
import torch

from galileo_sdr_sim_tpu.cli import _parse_time
from galileo_sdr_sim_tpu.constants import LUT_AMPLITUDE
from galileo_sdr_sim_tpu.models.e1 import E1_OS
from galileo_sdr_sim_tpu.rinex import read_rinex_v3
from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine, scenario_start_time

from .ops.synth_kp import COLS, P_GRID, _pack_codes_rs, kernel_operands, operands_to_device

CASES = ("random", "half_chip", "carrier_wrap", "negated_mu", "edges")
BAR_MATCH = 0.999  # share of int16 values that must be identical
BAR_MAX_DIFF = 4 * LUT_AMPLITUDE  # one chip-transition timing ULP (1000)

FIXTURE_START = "2022/02/19,23:30:00"  # GST week 2197, 603000 s
FIXTURE_LLH = (42.3601, -71.0589, 2.0)  # Boston, the CLI's default site


def fixture_engine(nav_path, duration_s: float) -> ScenarioEngine:
    """The fixture scene of the nav file at `nav_path`, static receiver."""
    nav = read_rinex_v3(nav_path)
    g0 = scenario_start_time(nav, _parse_time(FIXTURE_START))
    return ScenarioEngine(nav, PositionProvider(llh_deg=np.array(FIXTURE_LLH)), g0, duration_s)


def synthetic_operands(B: int, C: int, seed: int, case: str = "random") -> tuple:
    """-> (host, codes_b, codes_c): host holds (B, C) float32 cp0, two_a,
    mu, carr0, fc, fc_k and (B, C, 32) float32 +-1 sym_win, pilot_win;
    codes are the (C, 8184) int8 E1B/E1C banks of PRNs 1..C.

    Cases: 'random'; 'half_chip' (code phases exactly on half chips);
    'carrier_wrap' (carrier phase just under 1 cycle); 'negated_mu'
    (negative code-Doppler drift); 'edges' (cp0 at 0 and just under
    4092, mu at +-3e-3 and 0).  Every case draws |fc| up to 3e-3
    cycles/sample, so fc_k wraps within the epoch."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    if not 1 <= C <= len(E1_OS.data_codes):
        raise ValueError(f"C={C} channels: need 1..{len(E1_OS.data_codes)}")
    rng = np.random.default_rng(seed)
    cp0 = rng.uniform(0, 4 * COLS, (B, C))
    mu = rng.uniform(-3e-3, 3e-3, (B, C))
    carr0 = rng.uniform(0, 1, (B, C))
    if case == "half_chip":
        cp0 = np.round(cp0 * 2) / 2
    elif case == "carrier_wrap":
        carr0 = np.full((B, C), np.nextafter(np.float32(1), np.float32(0)))
    elif case == "negated_mu":
        mu = -rng.uniform(5e-4, 3e-3, (B, C))
    elif case == "edges":
        cp0.flat[0] = 0.0
        cp0.flat[1 % cp0.size] = 4091.9999
        cp0.flat[C % cp0.size] = 2046.0
        mu[0, :] = 3e-3
        mu[min(1, B - 1), :] = -3e-3
        mu[-1, 0] = 0.0
    mu = mu.astype(np.float32)
    fc = rng.uniform(-3e-3, 3e-3, (B, C))
    fc_k = fc * P_GRID
    host = dict(
        cp0=cp0.astype(np.float32),
        two_a=((mu.astype(np.float64) + COLS) / P_GRID).astype(np.float32),
        mu=mu,
        carr0=carr0.astype(np.float32),
        fc=fc.astype(np.float32),
        fc_k=(fc_k - np.floor(fc_k)).astype(np.float32),
        sym_win=rng.choice([-1.0, 1.0], (B, C, 32)).astype(np.float32),
        pilot_win=rng.choice([-1.0, 1.0], (B, C, 32)).astype(np.float32),
    )
    codes_b = np.ascontiguousarray(E1_OS.data_codes[:C])
    codes_c = np.ascontiguousarray(E1_OS.pilot_codes[:C])
    return host, codes_b, codes_c


def synthetic_kp_inputs(B: int, C: int, seed: int, case: str, device) -> dict:
    """`synthetic_operands` as the kernel's operands on `device` (what
    `prepare_kp_inputs` returns for a scene)."""
    host, codes_b, codes_c = synthetic_operands(B, C, seed, case)
    inputs = operands_to_device(kernel_operands(host), device)
    inputs["vpack_rs"] = torch.from_numpy(_pack_codes_rs(codes_b, codes_c)).to(device)
    return inputs


def engine_bar(a_packed: np.ndarray, b_packed: np.ndarray) -> dict:
    """Compare two packed int32 I/Q outputs on their int16 values ->
    {'match': share identical, 'max_abs_err': largest |difference|,
    'ok': whether the bar holds}."""
    a = np.ascontiguousarray(a_packed).view(np.int16).astype(np.int32)
    b = np.ascontiguousarray(b_packed).view(np.int16).astype(np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    match = float((diff == 0).mean()) if diff.size else 1.0
    max_err = int(diff.max()) if diff.size else 0
    return {
        "match": match,
        "max_abs_err": max_err,
        "ok": match >= BAR_MATCH and max_err <= BAR_MAX_DIFF,
    }
