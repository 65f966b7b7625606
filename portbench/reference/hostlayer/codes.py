"""Galileo E1 PRN code tables as dense NumPy arrays.

The reference expands one PRN at a time into malloc'd short buffers
(reference: src/gal-sig.cpp:9-233).  Here the full 50-PRN bank is expanded
once into `(50, 4092)` chip matrices and `(50, 8184)` BOC(1,1) half-chip
matrices — the natural layout for a TPU, where per-channel code slabs are
gathered rows of a resident int8 array.

Chip convention (gal-sig.cpp:25-186): hex bit 0 -> +1, bit 1 -> -1.
BOC(1,1) expansion (gal-sig.cpp:198-213): each chip becomes the half-chip
pair (-c, +c) — i.e. a sine-BOC subcarrier starting on the negative
half-cycle, matching the reference exactly.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "e1_codes.npz"


@functools.cache
def _load() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def _bits_to_chips(bits: np.ndarray) -> np.ndarray:
    """{0,1} bits -> ±1 chips, int8 (bit 0 -> +1)."""
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


@functools.cache
def primary_chips(component: str) -> np.ndarray:
    """(50, 4092) int8 ±1 primary code chips for 'E1B' or 'E1C'."""
    key = {"E1B": "e1b_bits", "E1C": "e1c_bits"}[component]
    return _bits_to_chips(_load()[key])


@functools.cache
def boc_chips(component: str) -> np.ndarray:
    """(50, 8184) int8 sine-BOC(1,1) half-chips for 'E1B' or 'E1C'.

    Matches the reference `sboc` output: half-chip pair (-c, +c) per chip.
    """
    chips = primary_chips(component)
    out = np.empty((chips.shape[0], 2 * chips.shape[1]), dtype=np.int8)
    out[:, 0::2] = -chips
    out[:, 1::2] = chips
    return out


@functools.cache
def secondary_code() -> np.ndarray:
    """(25,) int8 ±1 E1C secondary code (CS25_1).

    The hot loop maps stored bit b -> (b > 0 ? -1 : +1)
    (galileo-sdr.cpp:518); the returned array applies that mapping, so it
    multiplies the pilot directly.
    """
    bits = _load()["secondary"]
    return np.where(bits > 0, -1, 1).astype(np.int8)


@functools.cache
def sync_pattern() -> np.ndarray:
    """(10,) uint8 I/NAV page sync pattern 0101100000."""
    return _load()["sync"]


@functools.cache
def crc24q_table() -> np.ndarray:
    """(256,) uint32 CRC-24Q byte table (poly 0x1864CFB)."""
    return _load()["crc24q"]


@functools.cache
def carrier_lut() -> tuple[np.ndarray, np.ndarray]:
    """(cos512, sin512) int32 amplitude-250 carrier LUTs (parity mode)."""
    d = _load()
    return d["cos512"].astype(np.int32), d["sin512"].astype(np.int32)


def codegen_boc(prn: int, component: str) -> np.ndarray:
    """(8184,) int8 BOC(1,1) sequence for a 1-based PRN; mirrors
    codegen_E1B/codegen_E1C (gal-sig.cpp:219-233)."""
    return boc_chips(component)[prn - 1]
