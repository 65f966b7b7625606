"""Channel bank: visibility-driven allocation of satellites to slots.

Behavioural port of the reference channel manager (reference:
src/channel.cpp).  A fixed bank of MAX_CHAN slots; every 30 s scenario
seconds the visible-satellite set is re-evaluated (elevation mask
hard-coded to 10 deg like channel.cpp:60), newly-visible satellites claim
the lowest free slot, setting PRN codes, the first I/NAV page, the initial
pseudorange and the carrier-phase seed; satellites that dropped below the
mask free their slot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import geodesy
from .constants import MAX_CHAN, MAX_SAT, R2D
from .gnss_time import GalTime
from .inav import generate_inav_page, word_type_for
from .observables import compute_range, initial_carrier_phase
from .rinex import EphArrays, NavData


@dataclass
class Channel:
    """One active satellite channel (mirrors channel_t working state)."""

    prn: int = 0
    carr_phase: float = 0.0
    f_carr: float = 0.0
    f_code: float = 0.0
    code_phase: float = 0.0
    ibit: int = 0
    ipage: int = 0
    rho0_range: float = 0.0
    azel: tuple[float, float] = (0.0, 0.0)
    page: np.ndarray | None = None  # (500,) uint8 symbol bits
    eph_index: int = -1


@dataclass
class ChannelBank:
    channels: list[Channel] = field(
        default_factory=lambda: [Channel() for _ in range(MAX_CHAN)]
    )
    allocated: dict[int, int] = field(default_factory=dict)  # sv -> slot

    def active_slots(self) -> list[int]:
        return [i for i, c in enumerate(self.channels) if c.prn > 0]


def check_visibility(eph, grx: GalTime, xyz: np.ndarray, elv_mask_deg: float):
    """(visible, azel) for one ephemeris record (geodesy.cpp:318-343)."""
    pos, _, _ = geodesy.satpos(eph, grx.sec)
    azel = geodesy.azel_from(np.asarray(xyz, dtype=np.float64), pos)
    return bool(azel[1] * R2D > elv_mask_deg), azel


def allocate_channels(
    bank: ChannelBank,
    nav: NavData,
    grx: GalTime,
    xyz: np.ndarray,
    current_eph: list[int],
    verbose: bool = False,
) -> int:
    """Reference allocateChannel (channel.cpp:21-123).

    Note the reference passes an elevation mask but compares against the
    literal 10 degrees (channel.cpp:60); we keep that behaviour.
    """
    nsat = 0
    for sv in range(MAX_SAT):
        if not nav.eph[sv]:
            continue
        current_eph[sv] = nav.epoch_match(sv, grx)
        if current_eph[sv] < 0:
            continue
        eph = nav.eph[sv][current_eph[sv]]

        visible, azel = check_visibility(eph, grx, xyz, 10.0)
        if visible:
            nsat += 1
            if sv not in bank.allocated:
                for i, chan in enumerate(bank.channels):
                    if chan.prn == 0:
                        chan.prn = sv + 1
                        chan.azel = (float(azel[0]), float(azel[1]))
                        chan.eph_index = current_eph[sv]
                        chan.ibit = 0
                        chan.ipage = 0
                        chan.page = _page_bits(grx, eph, nav)
                        rho = compute_range(eph, nav.iono, grx.week, grx.sec, xyz)
                        chan.rho0_range = float(rho.range)
                        r_xyz = float(rho.range)
                        rho_ref = compute_range(
                            eph, nav.iono, grx.week, grx.sec, np.zeros(3)
                        )
                        r_ref = float(rho_ref.range)
                        chan.carr_phase = float(
                            initial_carrier_phase(r_ref, r_xyz)
                        )
                        bank.allocated[sv] = i
                        if verbose:
                            print(
                                f"{chan.prn:02d} {azel[0]*R2D:6.1f} {azel[1]*R2D:5.1f} "
                                f"{chan.rho0_range:11.1f} {grx.sec:5.5f}"
                            )
                        break
        elif sv in bank.allocated:
            bank.channels[bank.allocated[sv]].prn = 0
            del bank.allocated[sv]
    return nsat


def _page_bits(grx: GalTime, eph, nav: NavData) -> np.ndarray:
    """Generate the 500-symbol page for the current 2 s slot.

    Almanac words 7-10 carry real data derived from the loaded
    ephemerides (inav.AlmanacContext) — the reference emits dummy 63 in
    those slots (inav-msg.cpp:377-384); disable with
    nav.dummy_almanac = True for strict reference-output parity."""
    almanac = None
    if not getattr(nav, "dummy_almanac", False):
        from .inav import AlmanacContext

        almanac = AlmanacContext(nav).for_time(grx)
    return generate_inav_page(grx, eph, nav.iono, almanac=almanac)


def regenerate_page(
    chan: Channel, grx: GalTime, nav: NavData, bit_source=None
) -> None:
    """Page rollover inside the sample loop (galileo-sdr.cpp:497-506).

    With `bit_source` (the live nav-bit relay, UDP 7531 — socket.h:84-150),
    relayed symbols replace the synthesized page.  The reference fills the
    per-channel queues but never drains them in its hot loop (SURVEY quirk
    list); here the advertised "real-time navigation message relay" is
    completed: up to 500 queued symbols form the new page, any shortfall
    is back-filled from the ephemeris-synthesized page so the signal stays
    continuous when the relay under-runs.  Wire symbol +1 -> page bit 1,
    -1/0 -> page bit 0 (matching socket.h:127-133's 1/0 mapping).
    """
    sv = chan.prn - 1
    eph = nav.eph[sv][chan.eph_index]
    page = _page_bits(grx, eph, nav)
    if bit_source is not None:
        relayed = bit_source.pop_bits(chan.prn, len(page))
        if relayed:
            page = page.copy()
            page[: len(relayed)] = (np.asarray(relayed) == 1).astype(page.dtype)
    chan.page = page
    chan.ipage += 1
