"""E1 OS CBOC(6,1,1/11) signal model — the real OS modulation.

The reference transmits plain sine-BOC(1,1) (reference src/gal-sig.cpp:198
`sboc(m=1, n=1)`), and its own evaluation acquires with `cboc=false`
(reference gnss-sdr_Galileo_E1_ishort.conf:48).  Per the OS SIS ICD the
E1 OS signal is actually CBOC(6,1,1/11):

    E1B(t) = d(t) * c_B(t) * ( a*sc1(t) + b*sc6(t) )     (data, in phase)
    E1C(t) = c25  * c_C(t) * ( a*sc1(t) - b*sc6(t) )     (pilot, anti-phase)
    a = sqrt(10/11), b = sqrt(1/11)        (a^2 + b^2 = 1: same power)

with sc1 the 2-per-chip and sc6 the 12-per-chip square subcarriers.
This model represents each component as a (50, 12*4092) float32 value
table — the CBOC waveform sampled pointwise on the 12-subdivision chip
grid — exercising the signal-model seam with a genuinely different
modulation (different table length, dtype, and subcarrier geometry).
Both subcarriers use the reference's "starts negative" sign convention
(codes.boc_chips pairs each chip as (-c, +c)), so the sc1 component is
phase-aligned with the sine-BOC bank and a sine-BOC receiver correlates
at a = sqrt(10/11) of full power (-0.4 dB) — validated in
tests/test_cboc.py.

Engine note: the factorized (K,p)/Pallas engines run CBOC at the fused-
kernel rate.  The 12-grid tables factor exactly over the sine-BOC
half-chip banks — V(n) = halfchip(n)·(a ± b·τ(n)) with
τ = (−1)^(halfchip_index + floor(6·frac)) — so prepare_kp_inputs
derives the ±1 banks and (a, b) from these tables and the engines apply
τ as ~10 extra VPU ops per channel-sample (ops/synth_kp.py cboc
branch); the direct engine (ops/synth.py) consumes the tables verbatim
as the any-geometry reference path.  At 2.6 Msps the 6.138 MHz sc6
component is above Nyquist — pointwise sampling is the honest
representation at this rate (a band-limited front end would suppress
it; the receiver-facing sc1 term is exact).

Each component's table is built once a process (`_cboc_table` is
cached, as `codes.boc_chips` is) and is read-only: every reader shares
the one array, and a write into it raises.  The scenario engine keeps a
block's code rows while the channel map holds (scenario.py `_pack`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .. import codes
from ..constants import CA_SEQ_LEN_E1
from .e1 import E1SignalModel

CBOC_SUBDIV = 12  # sc6 sign intervals per chip
ALPHA = float(np.sqrt(10.0 / 11.0))
BETA = float(np.sqrt(1.0 / 11.0))


def _subcarrier_signs() -> tuple[np.ndarray, np.ndarray]:
    """(12,) sc1 and sc6 signs per sub-chip interval, 'starts negative'."""
    k = np.arange(CBOC_SUBDIV)
    sc1 = np.where(k < CBOC_SUBDIV // 2, -1.0, 1.0)
    sc6 = np.where(k % 2 == 0, -1.0, 1.0)
    return sc1, sc6


@functools.cache
def _cboc_table(component: str, anti: bool) -> np.ndarray:
    """(50, 12*4092) float32 pointwise CBOC values for one component,
    built once and read-only (shared by every caller)."""
    chips = codes.primary_chips(component).astype(np.float32)  # (50, 4092)
    sc1, sc6 = _subcarrier_signs()
    wave = (ALPHA * sc1 + (-BETA if anti else BETA) * sc6).astype(np.float32)
    table = (chips[:, :, None] * wave[None, None, :]).reshape(
        chips.shape[0], CA_SEQ_LEN_E1 * CBOC_SUBDIV
    )
    table.setflags(write=False)
    return table


@dataclass(frozen=True)
class E1CbocSignalModel(E1SignalModel):
    """E1 OS with the full CBOC(6,1,1/11) modulation."""

    name: str = "E1-OS-CBOC"
    boc_length: int = CA_SEQ_LEN_E1 * CBOC_SUBDIV
    code_subdiv: int = CBOC_SUBDIV

    @property
    def data_codes(self) -> np.ndarray:
        """(50, 49104) float32 CBOC E1B component values (in-phase sc6)."""
        return _cboc_table("E1B", anti=False)

    @property
    def pilot_codes(self) -> np.ndarray:
        """(50, 49104) float32 CBOC E1C component values (anti-phase sc6)."""
        return _cboc_table("E1C", anti=True)


E1_CBOC = E1CbocSignalModel()
