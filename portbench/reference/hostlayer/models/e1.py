"""Galileo E1 OS signal model.

The signal-model layer separates *what a signal is* (code structure,
modulation, message framing, timing) from the engines that evaluate it
(scenario engine, device synthesis).  E1 OS is the flagship — and the only
model the reference implements — but everything the synthesis path needs
is captured here as data + small functions, so additional Galileo signals
(E5a/E5b AltBOC, E6) or constellations slot in as sibling modules with
the same interface.

E1 OS per the OS SIS ICD (and reference behaviour, src/gal-sig.cpp,
src/inav-msg.cpp):

* two components: E1B (data, I/NAV at 250 sym/s) and E1C (pilot, 25-chip
  secondary code at symbol rate);
* 4092-chip primary memory codes at 1.023 Mcps, sine-BOC(1,1) subcarrier
  (the reference transmits sine-BOC rather than full CBOC; GNSS-SDR's eval
  config acquires with cboc=false accordingly);
* composite baseband: e(t) = E1B(t)·d(t) − E1C(t)·c25(t), constant
  envelope per component, equal powers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import codes
from ..constants import (
    BOC_SEQ_LEN_E1,
    CA_SEQ_LEN_E1,
    CARR_FREQ,
    CARR_TO_CODE_E1,
    CODE_FREQ_E1,
    LAMBDA_E1,
    N_SYM_PAGE,
    PAGE_TRANS_TIME,
    SYMBOL_TIME_MS,
)


@dataclass(frozen=True)
class E1SignalModel:
    """Static description of the E1 OS signal."""

    name: str = "E1-OS"
    carrier_hz: float = CARR_FREQ
    wavelength_m: float = LAMBDA_E1
    chip_rate_hz: float = CODE_FREQ_E1
    code_length_chips: int = CA_SEQ_LEN_E1
    boc_length: int = BOC_SEQ_LEN_E1  # half-chips after BOC(1,1)
    carrier_to_code: float = CARR_TO_CODE_E1
    symbol_time_ms: int = SYMBOL_TIME_MS
    symbols_per_page: int = N_SYM_PAGE
    page_seconds: int = PAGE_TRANS_TIME
    # subcarrier sign intervals per chip; 2 = sine-BOC(1,1) (the fast
    # (K,p)/Pallas engines assume this geometry), 12 = CBOC(6,1,1/11)
    # (models/cboc.py; routed to the direct engine)
    code_subdiv: int = 2

    # --- code banks (lazily loaded dense arrays) ----------------------

    @property
    def data_codes(self) -> np.ndarray:
        """(50, 8184) int8 BOC(1,1) E1B sequences."""
        return codes.boc_chips("E1B")

    @property
    def pilot_codes(self) -> np.ndarray:
        """(50, 8184) int8 BOC(1,1) E1C sequences."""
        return codes.boc_chips("E1C")

    @property
    def secondary_code(self) -> np.ndarray:
        """(25,) int8 ±1 pilot secondary chips (CS25_1)."""
        return codes.secondary_code()

    def doppler_to_code_rate(self, f_carr_hz: float) -> float:
        """Carrier Doppler -> chip rate (gal-sig.cpp:320)."""
        return self.chip_rate_hz + f_carr_hz * self.carrier_to_code

    def generate_page(self, grx, eph, iono) -> np.ndarray:
        """One 2 s page pair -> (500,) transmitted symbol bits."""
        from ..inav import generate_inav_page

        return generate_inav_page(grx, eph, iono)


E1_OS = E1SignalModel()
