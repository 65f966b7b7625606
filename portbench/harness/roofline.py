"""The table of peaks and the work counts of the kernels the benchmark
reads, written in as constants so that they count the same work whatever
implements it.

Peaks: one NVIDIA H100 SXM at its 700 W limit (data sheet, dense): 67
TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.  A kernel's
least time is the larger of its float32 operations over the first and its
bytes over the second, each input byte read once and each output byte
written once.

The kp pair (the prologue and the main kernel of csrc/synth_kp_v5.cu, one
call a block: of B epochs, or band-limited of the block's 12 phase
streams stacked, 12 x B epochs) counts as the work of the whole call:
the operations of its main loop, counted from the source when the
benchmark was defined (an FMA counts 2; integer bit operations and int8 ->
float conversions are not counted, nor the per-(c, p) prologue and the K
factors, under 2% of the rest): per (channel, sample) 29, plus 5 under CBOC
and 1 with gain; per (channel, row of 8 K, column) 26.  Bytes: the eleven
(B, C) 4-byte operands (twelve with gain), the 32 code-table taps each
(epoch, channel, column) selects, and the packed int32 I/Q output.  The
planes the prologue hands the main kernel are the design's own traffic and
are not counted.

The band-limit filter (ops/bandlimit.filter_block) is a 12-phase polyphase
convolution with the 385-tap low-pass: per output sample and component 385
multiply-adds; bytes: its float32 input of 12 phases x 2 components x
(B x 260000 + 32) samples, its float32 output of 2 x B x 260000, and its
12 x 33 float32 weights.
"""

from __future__ import annotations

FP32_PEAK = 67e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s

P_GRID = 1300  # samples a grid row
K_EPOCH = 200  # grid rows an epoch: 260000 samples
W_PACK = 32  # code-table taps an (epoch, channel, column) selects
KP_OPERANDS = 11  # (B, C) operands of a call, without gain
KP_OPS_SAMPLE, KP_OPS_CBOC, KP_OPS_GAIN, KP_OPS_KAP = 29, 5, 1, 26

NSAMPLES = 260000
FILTER_TAPS = 385
FILTER_PHASES = 12
FILTER_WINDOW = 33  # polyphase taps a phase
FILTER_HISTORY = 32


def least_s(ops: float, nbytes: float) -> float:
    """Seconds the work takes at the card's peaks."""
    return max(ops / FP32_PEAK, nbytes / HBM_RATE)


def kp_least_s(B: int, C: int, cboc: bool, gain: bool, n_k: int = K_EPOCH) -> float:
    """Least time of one kp call of B epochs and C channels."""
    per_sample = KP_OPS_SAMPLE + KP_OPS_CBOC * cboc + KP_OPS_GAIN * gain
    ops = B * C * n_k * P_GRID * per_sample + B * C * (n_k // 8) * P_GRID * KP_OPS_KAP
    nbytes = (B * C * 4 * (KP_OPERANDS + gain) + B * C * P_GRID * W_PACK
              + B * n_k * P_GRID * 4)
    return least_s(ops, nbytes)


def filter_least_s(B: int) -> float:
    """Least time of one band-limit filter call on a block of B epochs."""
    n = B * NSAMPLES
    ops = 2 * 2 * FILTER_TAPS * n
    nbytes = 4 * (FILTER_PHASES * 2 * (n + FILTER_HISTORY) + 2 * n
                  + FILTER_PHASES * FILTER_WINDOW)
    return least_s(ops, nbytes)
