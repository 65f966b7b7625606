"""Scenario engine: turns (RINEX, position stream, start time) into dense
per-epoch channel state tables for the TPU synthesizer.

This is the TPU-first re-architecture of the reference's orchestrator
(reference: src/galileo-sdr.cpp:58-647).  The reference interleaves scalar
observable updates with a per-sample NCO loop; here the host engine
advances the *slow* state (orbits, observables, I/NAV pages, channel
allocation — 10 Hz cadence) and emits, per 0.1 s epoch, an
`EpochStateTable` whose phases are affine in the sample index.  The device
consumes whole blocks of epochs and synthesizes all samples in parallel
(ops/synth.py, ops/pallas_synth.py).

Timing parity notes (galileo-sdr.cpp):
* dt = 0.10000002314 s while the sample clock advances exactly
  260000/2.6e6 s per epoch (line 347) — both kept.
* grx is incremented once before channel allocation (line 348) and once
  more before the epoch loop (line 436): the first emitted epoch is at
  g0 + 2 dt, and `numd - 1` epochs are emitted for a duration of numd/10 s.
* Every 30 scenario seconds (igrx % 300 == 0) ephemerides are re-matched
  and channels reallocated *after* the epoch is synthesized (lines
  544-562).
* Carrier phase carries continuously across epochs; code phase and symbol
  counters are re-derived analytically each epoch from the pseudorange
  (computeCodePhase), exactly like the reference.

The port's copy differs from the JAX package's text in four ways
(tests/test_torch_host_layer.py holds the tables equal):
* it steps epochs through one path, `_step_block`, a chunk of m >= 1
  epochs at a time, where the JAX package has `_step` for one epoch
  beside it;
* its spans (profiling.span; nothing without an installed Timer):
  `geometry` (the receiver position, the stacked ephemerides,
  `compute_range`, `code_phase_state` and the gains),
  `nav_page` (each `regenerate_page`), `realloc` (the 30 s refresh),
  `pack` (`_pack`) and inside it `codes` (the block's code rows), and
  inside that `rows` (the rows built anew from the model's tables: it
  opens only when the channel map changes, so its entries count the
  rebuilds, the maps a job stepped).  In the streaming executor they are
  sections `scenario/<path>`;
* `_pack` keeps the last block's code rows, read-only, while the PRN
  map holds (the JAX package copies the rows from the tables every
  block); the CBOC tables are built once a process (models/cboc.py);
* `epochs` and `batches` take stepped tables from one buffer (`_take`),
  and `batches` is one loop for every position source.  A live position
  steps each batch in one `_step_block`, where the JAX package steps an
  epoch at a time and steps the next batch's first epoch before it
  yields a batch; here every position is read after the batch before its
  own was yielded.  The bit relay's one-shot TOW correction, which comes
  at no set epoch, is read once a chunk, in `_take`, and lands on the
  first epoch of the next chunk stepped (the JAX package's live path:
  the next epoch).  It moves the clock before the chunk is sized, so
  that the chunk still ends at the 30 s boundary (the JAX package reads
  it in `_step_block`, after sizing the chunk, and a correction that
  moves the boundary inside the chunk skips that reallocation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from . import geodesy
from .channels import ChannelBank, allocate_channels, regenerate_page
from .models.e1 import E1_OS, E1SignalModel
from .constants import (
    CA_SEQ_LEN_E1,
    EPOCH_DT,
    MAX_CHAN,
    MAX_SAT,
    N_SYM_PAGE,
    NUM_IQ_SAMPLES,
    R2D,
    SAMP_RATE,
)
from .gnss_time import GalTime, gal2date
from .observables import code_phase_state, compute_range
from .profiling import span
from .rinex import NavData

SYM_WIN = 32  # symbols covered per epoch window (<= 27 used)

# Receiver antenna attenuation in dB for boresight 0:5:180 deg
# (galileo-sdr.cpp:50-54); gain is computed for parity/UI but, like the
# reference (lines 520-521), not applied to the mix unless requested.
ANT_PAT_DB = np.array(
    [0.00, 0.00, 0.22, 0.44, 0.67, 1.11, 1.56, 2.00, 2.44, 2.89, 3.56, 4.22,
     4.89, 5.56, 6.22, 6.89, 7.56, 8.22, 8.89, 9.78, 10.67, 11.56, 12.44,
     13.33, 14.44, 15.56, 16.67, 17.78, 18.89, 20.00, 21.33, 22.67, 24.00,
     25.56, 27.33, 29.33, 31.56]
)


@dataclass
class EpochStateTable:
    """Per-epoch, per-channel synthesis seeds (all shape (MAX_CHAN, ...))."""

    grx_sec: float
    prn: np.ndarray  # int32, 0 = inactive
    f_carr: np.ndarray  # float64 [Hz]
    f_code: np.ndarray  # float64 [chips/s]
    code_phase0: np.ndarray  # float64 [chips, 0..4092)
    carr_phase0: np.ndarray  # float64 [cycles, (-1..1)]
    ibit0: np.ndarray  # int32 symbol index at epoch start
    sym_win: np.ndarray  # int8 (MAX_CHAN, SYM_WIN) data symbols (+-1)
    pilot_win: np.ndarray  # int8 (MAX_CHAN, SYM_WIN) secondary chips (+-1)
    gain: np.ndarray  # float32 path-loss * antenna gain * 128
    azel: np.ndarray  # float64 (MAX_CHAN, 2) for status display


@dataclass
class EpochBatch:
    """A contiguous block of epochs with a fixed channel->PRN mapping,
    stacked for device consumption (leading axis = epoch)."""

    grx_sec: np.ndarray  # (B,)
    prn: np.ndarray  # (MAX_CHAN,) fixed across the batch
    f_carr: np.ndarray  # (B, MAX_CHAN)
    f_code: np.ndarray
    code_phase0: np.ndarray
    carr_phase0: np.ndarray
    sym_win: np.ndarray  # (B, MAX_CHAN, SYM_WIN)
    pilot_win: np.ndarray
    gain: np.ndarray
    codes_b: np.ndarray  # (MAX_CHAN, 8184) int8, zero rows for idle slots
    codes_c: np.ndarray


class PositionProvider:
    """Receiver position source: static, per-epoch trajectory, or live."""

    def __init__(
        self,
        llh_deg: np.ndarray | None = None,
        trajectory: np.ndarray | None = None,
        live: Callable[[], np.ndarray] | None = None,
    ):
        self._static = None if llh_deg is None else np.asarray(llh_deg, float)
        self._traj = None if trajectory is None else np.asarray(trajectory, float)
        self._live = live

    def llh_deg(self, epoch: int) -> np.ndarray:
        if self._live is not None:
            return np.asarray(self._live(), dtype=np.float64)
        if self._traj is not None:
            idx = min(epoch, len(self._traj) - 1)
            return self._traj[idx]
        return self._static


class ScenarioEngine:
    """Iterates epochs, maintaining channel state, yielding state tables."""

    def __init__(
        self,
        nav: NavData,
        position: PositionProvider,
        g0: GalTime,
        duration_s: float,
        verbose: bool = False,
        bit_source=None,
        model: E1SignalModel = E1_OS,
    ):
        self.nav = nav
        self.position = position
        self.verbose = verbose
        # the signal model supplies code banks, the pilot secondary code,
        # and framing constants — the seam where E5a/E6 models plug in
        self.model = model
        # live nav-bit relay (io/udp.py LiveState): pages come from UDP
        # 7531 symbols; a one-shot TOW correction shifts grx on first
        # reception (galileo-sdr.cpp:606-615, socket.h:140-147)
        self.bit_source = bit_source
        self._tow_applied = False
        self.numd = int(duration_s * 10.0 + 0.5)
        self.bank = ChannelBank()
        self.current_eph = [-1] * MAX_SAT
        self.g0 = g0
        self._delt = 1.0 / SAMP_RATE
        self._block_T = NUM_IQ_SAMPLES * self._delt
        self._eph_cache: tuple = (None, None)
        # (PRN map bytes, (codes_b, codes_c)): the rows of the last map
        # packed, read-only, shared by every batch packed under that map
        self._rows_cache: tuple = (None, None)
        # chunked-lookahead buffer: tabs computed but not yet yielded.
        # Engine state (grx, channels) is committed through the END of the
        # buffered chunk; checkpoint.py serializes the buffer so resume is
        # exact even mid-chunk.
        self._pending: list[EpochStateTable] = []
        self._pending_base: int = 0  # iumd of _pending[0]
        self._next_iumd: int = 1  # next epoch index to be yielded
        # replay ring of recently YIELDED tabs (iumd, tab): a pipelined
        # consumer (io/stream.py, pipeline_depth >= 1) holds yielded-but-
        # not-yet-drained blocks in flight, and a checkpoint must be able
        # to rewind to the last epoch the sink actually received —
        # checkpoint.save_state re-buffers these tabs as pending.  0 =
        # keep nothing (non-checkpointing callers pay no cost).
        self._replay_keep: int = 0
        self._replay: list[tuple[int, EpochStateTable]] = []

        llh0 = self.position.llh_deg(0)
        xyz0 = geodesy.llh2xyz(np.array([llh0[0] / R2D, llh0[1] / R2D, llh0[2]]))

        for sv in range(MAX_SAT):
            self.current_eph[sv] = nav.epoch_match(sv, g0)

        # grx advanced once before allocation (galileo-sdr.cpp:348).
        self.grx = g0 + EPOCH_DT
        allocate_channels(
            self.bank, nav, self.grx, xyz0, self.current_eph, verbose=verbose
        )
        # ...and once more before the loop (line 436).
        self.grx = self.grx + EPOCH_DT

    def __len__(self) -> int:
        return max(self.numd - 1, 0)

    # epochs per vectorized host chunk (fast path); chunks always end at
    # 30 s reallocation boundaries so the channel map is constant within
    CHUNK = 32

    def epochs(self, start: int = 1) -> Iterator[EpochStateTable]:
        """Yield epoch state tables; `start` > 1 continues a resumed run
        (see checkpoint.py) — grx/channel state must already be restored.

        Positions known ahead of time (static / trajectory) take the
        vectorized chunk path (one observables call per CHUNK epochs).
        A live position is read only when its epoch is asked for: here
        one epoch at a time (one-epoch chunks), in `batches` one block at
        a time."""
        self._open(start)
        while tabs := self._take(1):
            yield tabs[0]

    def _open(self, start: int) -> None:
        """Begin at epoch `start`.  The tables a restored snapshot buffered
        (checkpoint.py: a chunk's lookahead, or a pipelined run's in-flight
        epochs) are taken first: engine state is committed through them."""
        if not (self._pending and self._pending_base == start):
            self._pending = []
            self._pending_base = start

    def _take(self, n: int) -> list[EpochStateTable]:
        """The next tables, at most n and all of one channel map, recorded
        as yielded: the buffered ones first, else a chunk stepped now.  A
        live position steps only the epochs asked for (at most n, one
        `_step_block`); other positions step CHUNK epochs and buffer the
        rest."""
        if not self._pending and self._pending_base < self.numd:
            # a TOW correction that arrived moves the clock before the
            # chunk is sized, so the chunk still ends at the 30 s boundary
            self._apply_tow_correction()
            live = self.position._live is not None
            iumd = self._pending_base
            m = self._chunk_len(iumd, n if live else self.CHUNK)
            self._pending = self._step_block(iumd, m)
        # a snapshot's buffered tables may cross a channel-map change
        k = 1
        while k < min(n, len(self._pending)) and np.array_equal(
            self._pending[k].prn, self._pending[0].prn
        ):
            k += 1
        tabs, self._pending = self._pending[:k], self._pending[k:]
        for tab in tabs:
            self._record_replay(self._pending_base, tab)
            self._pending_base += 1
        self._next_iumd = self._pending_base
        return tabs

    def _record_replay(self, iumd: int, tab: EpochStateTable) -> None:
        if self._replay_keep:
            self._replay.append((iumd, tab))
            if len(self._replay) > self._replay_keep:
                del self._replay[: len(self._replay) - self._replay_keep]

    def _chunk_len(self, iumd: int, most: int) -> int:
        """Epochs from iumd up to and including the next reallocation
        boundary (igrx % 300 == 0), capped at `most` / scenario end / week
        rollover (satpos handles week wrap, but keep chunks single-week)."""
        g = self.grx
        m = 0
        limit = min(most, self.numd - iumd)
        while m < limit:
            if g.week != self.grx.week:
                break
            m += 1
            if int(g.sec * 10.0 + 0.5) % 300 == 0:
                break
            g = g + EPOCH_DT
        return max(m, 1)

    def _step_block(self, iumd0: int, m: int) -> list[EpochStateTable]:
        """Step the m epochs from iumd0 on, m >= 1, all of one channel map
        (`_chunk_len` sized them): one compute_range / code_phase_state
        evaluation over (epoch, channel), then each epoch's pages, windows
        and carrier carried in plain Python.  The chunk's last epoch is the
        only one that can fall on a 30 s boundary, and the reallocation
        there runs after it is stepped."""
        nav, bank = self.nav, self.bank
        gs = []
        g = self.grx
        for _ in range(m):
            gs.append(g)
            g = g + EPOCH_DT

        with span("geometry"):
            llh_rows = np.stack(
                [self.position.llh_deg(iumd0 + e) for e in range(m)]
            ).astype(np.float64)
            llh_rad = np.stack(
                [llh_rows[:, 0] / R2D, llh_rows[:, 1] / R2D, llh_rows[:, 2]],
                axis=-1,
            )
            xyz = geodesy.llh2xyz(llh_rad)  # (m, 3)
            t_sec = np.array([gi.sec for gi in gs])  # (m,)

            act = [
                (i, chan) for i, chan in enumerate(bank.channels) if chan.prn > 0
            ]
            if act:
                from .rinex import EphArrays

                recs = []
                for _, chan in act:
                    sv = chan.prn - 1
                    chan.eph_index = self.current_eph[sv]
                    recs.append(nav.eph[sv][self.current_eph[sv]])
                # the stacked view only changes at channel (re)allocation or
                # the 30 s ephemeris refresh
                key = tuple(id(r) for r in recs)
                if self._eph_cache[0] == key:
                    eph_arr = self._eph_cache[1]
                else:
                    eph_arr = EphArrays.from_records(recs)
                    self._eph_cache = (key, eph_arr)

                rho = compute_range(
                    eph_arr.reshape((1, len(act))), nav.iono, gs[0].week,
                    t_sec[:, None], xyz[:, None, :],
                )  # fields (m, S)
                rho0 = np.concatenate(
                    [
                        np.array([[chan.rho0_range for _, chan in act]]),
                        rho.range[:-1],
                    ]
                )
                nco = code_phase_state(rho0, rho.range, EPOCH_DT, t_sec[:, None])
                # gain (computed, not applied — galileo-sdr.cpp:470-477)
                path_loss = 20200000.0 / rho.d
                ibs = ((90.0 - rho.azel[..., 1] * R2D) / 5.0).astype(np.int64)
                gains = (
                    path_loss * 10.0 ** (-ANT_PAT_DB[ibs] / 20.0) * 128.0
                ).astype(np.float32)

        sec = self.model.secondary_code
        tabs: list[EpochStateTable] = []
        for e in range(m):
            grx = gs[e]
            tab = EpochStateTable(
                grx_sec=grx.sec,
                prn=np.zeros(MAX_CHAN, np.int32),
                f_carr=np.zeros(MAX_CHAN),
                f_code=np.full(MAX_CHAN, 1.023e6),
                code_phase0=np.zeros(MAX_CHAN),
                carr_phase0=np.zeros(MAX_CHAN),
                ibit0=np.zeros(MAX_CHAN, np.int32),
                sym_win=np.ones((MAX_CHAN, SYM_WIN), np.int8),
                pilot_win=np.ones((MAX_CHAN, SYM_WIN), np.int8),
                gain=np.zeros(MAX_CHAN, np.float32),
                azel=np.zeros((MAX_CHAN, 2)),
            )
            for j, (i, chan) in enumerate(act):
                chan.azel = (float(rho.azel[e, j, 0]), float(rho.azel[e, j, 1]))
                chan.f_carr = float(nco.f_carr[e, j])
                chan.f_code = float(nco.f_code[e, j])
                chan.code_phase = float(nco.code_phase[e, j])
                chan.ibit = int(nco.ibit[e, j])
                chan.ipage = int(nco.ipage[e, j])
                chan.rho0_range = float(rho.range[e, j])
                tab.gain[i] = gains[e, j]

                a = chan.f_code * self._delt
                total_wraps = int(
                    np.floor(
                        (chan.code_phase + a * (NUM_IQ_SAMPLES - 1))
                        / CA_SEQ_LEN_E1
                    )
                )
                cur_page = chan.page
                if chan.ibit + total_wraps >= N_SYM_PAGE:
                    with span("nav_page"):
                        regenerate_page(chan, grx, nav, self.bit_source)
                nxt_page = chan.page

                idx = chan.ibit + np.arange(SYM_WIN)
                bits = np.where(
                    idx < N_SYM_PAGE,
                    cur_page[np.minimum(idx, N_SYM_PAGE - 1)],
                    nxt_page[(idx - N_SYM_PAGE) % N_SYM_PAGE],
                )
                tab.sym_win[i] = np.where(bits > 0, -1, 1)
                tab.pilot_win[i] = sec[idx % 25]

                tab.prn[i] = chan.prn
                tab.f_carr[i] = chan.f_carr
                tab.f_code[i] = chan.f_code
                tab.code_phase0[i] = chan.code_phase
                tab.carr_phase0[i] = chan.carr_phase
                tab.ibit0[i] = chan.ibit
                tab.azel[i] = chan.azel

                phase = chan.carr_phase + chan.f_carr * self._block_T
                chan.carr_phase = phase - np.trunc(phase)
            tabs.append(tab)

        # 30 s ephemeris refresh + reallocation (galileo-sdr.cpp:544-562)
        grx = gs[-1]
        if int(grx.sec * 10.0 + 0.5) % 300 == 0:
            with span("realloc"):
                for sv in range(MAX_SAT):
                    self.current_eph[sv] = nav.epoch_match(sv, grx)
                allocate_channels(
                    bank, nav, grx, xyz[-1], self.current_eph,
                    verbose=self.verbose,
                )

        self.grx = grx + EPOCH_DT
        return tabs

    def _apply_tow_correction(self) -> None:
        """One-shot grx shift when the bit relay reports its TOW
        (reference: local_fix/tow_fixed, galileo-sdr.cpp:606-615).  The
        relay's thread sets the correction at no set epoch: it is read once
        a chunk, before the chunk is sized."""
        if self.bit_source is None or self._tow_applied:
            return
        shift = getattr(self.bit_source, "tow_correction", None)
        if shift is not None:
            self.grx = (self.grx + float(shift)).normalized()
            self._tow_applied = True

    def batches(self, block_epochs: int, start: int = 1) -> Iterator[EpochBatch]:
        """Group consecutive epochs into device-sized batches; a batch is
        cut early whenever the channel->PRN mapping changes.  A live
        position's batch is stepped when it is asked for, in one
        `_step_block` (two where a 30 s boundary that keeps the map, or a
        week rollover, falls inside it), and yielded before any position
        of the next is read: at B = 1 a UDP 7533 update seen while block k
        drains reaches emitted samples at block k+2 (0.2 s, the
        reference's FIFO depth, constants.h:82-83).  The map changes only
        at a reallocation, which ends a chunk, so the next epoch's map is
        the next buffered table's, or else the bank's: no epoch is stepped
        ahead to find it."""
        self._open(start)
        block: list[EpochStateTable] = []
        while tabs := self._take(block_epochs - len(block)):
            block += tabs
            nxt = (
                self._pending[0].prn if self._pending
                else [chan.prn for chan in self.bank.channels]
            )
            if len(block) == block_epochs or not np.array_equal(block[-1].prn, nxt):
                yield self._pack(block)
                block = []
        if block:
            yield self._pack(block)

    def _pack(self, tabs: list[EpochStateTable]) -> EpochBatch:
        with span("pack"):
            prn = tabs[0].prn
            with span("codes"):
                key = prn.tobytes()
                if self._rows_cache[0] != key:
                    with span("rows"):
                        self._rows_cache = (key, self._code_rows(prn))
                cb, cc = self._rows_cache[1]
            return EpochBatch(
                grx_sec=np.array([t.grx_sec for t in tabs]),
                prn=prn.copy(),
                f_carr=np.stack([t.f_carr for t in tabs]),
                f_code=np.stack([t.f_code for t in tabs]),
                code_phase0=np.stack([t.code_phase0 for t in tabs]),
                carr_phase0=np.stack([t.carr_phase0 for t in tabs]),
                sym_win=np.stack([t.sym_win for t in tabs]),
                pilot_win=np.stack([t.pilot_win for t in tabs]),
                gain=np.stack([t.gain for t in tabs]),
                codes_b=cb,
                codes_c=cc,
            )

    def _code_rows(self, prn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(MAX_CHAN, boc_length) data and pilot code rows of a PRN map,
        zero rows for idle slots, read-only (batches in flight share
        them).  The dtype follows the model's tables: int8 ±1 half-chips
        for sine-BOC, float32 waveform values for CBOC (models/cboc.py)."""
        data, pilot = self.model.data_codes, self.model.pilot_codes
        cb = np.zeros((MAX_CHAN, self.model.boc_length), data.dtype)
        cc = np.zeros((MAX_CHAN, self.model.boc_length), data.dtype)
        active = prn > 0
        if np.any(active):
            cb[active] = data[prn[active] - 1]
            cc[active] = pilot[prn[active] - 1]
        cb.setflags(write=False)
        cc.setflags(write=False)
        return cb, cc


def scenario_start_time(
    nav: NavData, g0: GalTime | None, timeoverwrite: bool = False
) -> GalTime:
    """Resolve the scenario start (set_scenario_start_time,
    gnss-time.cpp:101-167).  With -T (timeoverwrite), the reference shifts
    all TOC/TOE by the g0-gmin delta (rounded to 7200 s); we implement that
    correctly on the records actually used (the reference's version
    iterates a stale array and is effectively a no-op, SURVEY quirk list).
    """
    gmin, gmax = nav.time_window()
    if g0 is None or g0.week < 0:
        return GalTime(gmin.week, gmin.sec)
    if timeoverwrite:
        gtmp = GalTime(g0.week, float(int(g0.sec) // 7200 * 7200))
        dsec = gtmp - gmin
        nav.iono.wnt = gtmp.week
        nav.iono.tot = int(gtmp.sec)
        for recs in nav.eph:
            for rec in recs:
                # normalize so satpos week-wrapped time differences and the
                # Earth-rotation term (OMEGA_EARTH * toe.sec) stay valid
                rec.toc = (rec.toc + dsec).normalized()
                rec.toe = (rec.toe + dsec).normalized()
        return g0
    if (g0 - gmin) < 0.0 or (gmax - g0) < 0.0:
        t0 = gal2date(g0)
        raise ValueError(
            f"Invalid start time {t0.y}/{t0.m:02d}/{t0.d:02d} "
            f"{t0.hh:02d}:{t0.mm:02d}:{t0.sec:02.0f} outside ephemeris window"
        )
    return g0
