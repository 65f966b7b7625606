"""PyTorch/CUDA port of galileo_sdr_sim_tpu for NVIDIA Hopper GPUs.

The JAX package `galileo_sdr_sim_tpu` stays the reference; this package
imports nothing of it.  Its host layer is a copy of the reference's
JAX-free modules at the same relative paths (constants, gnss_time, codes,
geodesy, rinex, iono, fec2, inav, observables, channels, models/,
scenario, noise, rx_track, io/sinks, io/udp, io/native_fifo, the tables
in data/, and profiling.Timer), held equal to the originals by the
tests.  The device layer is its own:

* ops/synth_kp.py      host prep of the factorized (K, p) engine and its
                       plain PyTorch version;
* ops/synth_kp_cuda.py the hand-written CUDA kernel (csrc/synth_kp_v5.cu)
                       that replaces the Pallas kernel `_kernel_v5` in its
                       sine-BOC/CBOC, gain, int16 and f32 branches, in
                       its K-vectorised main loop (`vec_kt=True`);
* ops/gather_probe.py  the in-tile gather probe (csrc/gather_probe.cu);
* ops/bandlimit.py     the band-limited CBOC mode (12 phase streams from
                       one kernel call, and a polyphase filter);
* ops/synth.py         the direct engine (fallback and lut512 parity);
* io/stream.py         the streaming executor;
* parallel/mesh.py     the (time, sat) rank mesh over torch.distributed;
* parallel/distributed.py  multi-process file generation;
* cli.py               the command line (`python -m galileo_sdr_sim_tpu_torch.cli`).

Nothing here imports JAX.
"""

__version__ = "0.1.0"
