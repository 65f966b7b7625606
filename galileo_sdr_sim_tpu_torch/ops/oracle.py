"""NumPy float64 parity oracle for the sample-rate synthesis.

Replicates the reference hot loop's per-sample semantics
(reference: src/galileo-sdr.cpp:481-539) in closed form:

* code phase at sample n is cp0 + f_code*delt*n, wrapped into [0, 4092) —
  identical to the reference's wrap-before-evaluate NCO because cp0 is in
  [0, 4092) and the per-sample increment is < 1 chip;
* symbol index advances by the wrap count (one per code period);
* carrier LUT index is the C expression `((int)(511*phase)) & 511`
  including its truncate-toward-zero + two's-complement behaviour on
  negative phases;
* mixing is integer: (E1B*d - E1C*s) * LUT, accumulated over channels,
  truncated to int16.

The only deviation from the C loop is accumulating phases in closed form
instead of 260000 sequential float additions, which differs by at most a
few ULPs of drift per epoch.  Used as the ground truth for kernel tests.
"""

from __future__ import annotations

import numpy as np

from ..codes import carrier_lut
from ..constants import CA_SEQ_LEN_E1, NUM_IQ_SAMPLES, SAMP_RATE
from ..scenario import EpochBatch

DELT = 1.0 / SAMP_RATE


def synth_epoch_oracle(batch: EpochBatch, e: int, nsamples: int = NUM_IQ_SAMPLES):
    """Synthesize one epoch of interleaved int16 I/Q, shape (2*nsamples,)."""
    cos512, sin512 = carrier_lut()
    n = np.arange(nsamples, dtype=np.float64)
    i_acc = np.zeros(nsamples, dtype=np.int64)
    q_acc = np.zeros(nsamples, dtype=np.int64)

    for c in range(len(batch.prn)):
        if batch.prn[c] <= 0:
            continue
        a = batch.f_code[e, c] * DELT
        total = batch.code_phase0[e, c] + a * n
        wraps = np.floor(total / CA_SEQ_LEN_E1).astype(np.int64)
        cp = total - wraps * CA_SEQ_LEN_E1
        icode = (cp * 2).astype(np.int64)

        chip_b = batch.codes_b[c, icode].astype(np.int64)
        chip_c = batch.codes_c[c, icode].astype(np.int64)
        d = batch.sym_win[e, c, wraps].astype(np.int64)
        s = batch.pilot_win[e, c, wraps].astype(np.int64)

        phase = batch.carr_phase0[e, c] + batch.f_carr[e, c] * DELT * n
        phase = phase - np.trunc(phase)
        itab = np.trunc(511.0 * phase).astype(np.int64) & 511
        cosph = cos512[itab]
        sinph = sin512[itab]

        m = chip_b * d - chip_c * s
        i_acc += m * cosph
        q_acc += m * sinph

    iq = np.empty(2 * nsamples, dtype=np.int16)
    iq[0::2] = i_acc.astype(np.int16)
    iq[1::2] = q_acc.astype(np.int16)
    return iq
