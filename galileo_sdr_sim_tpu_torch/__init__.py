"""PyTorch/CUDA port of galileo_sdr_sim_tpu for NVIDIA Hopper GPUs.

The JAX package `galileo_sdr_sim_tpu` stays the reference.  This package
reuses its JAX-free host layer (scenario, RINEX, sinks, UDP, receiver)
and replaces the device layer:

* ops/synth_kp.py      host prep of the factorized (K, p) engine and its
                       plain PyTorch version;
* ops/synth_kp_cuda.py the hand-written CUDA kernel (csrc/synth_kp_v5.cu)
                       that replaces the Pallas kernel `_kernel_v5`;
* ops/synth.py         the direct engine (fallback and lut512 parity);
* io/stream.py         the streaming executor;
* cli.py               the command line (`python -m galileo_sdr_sim_tpu_torch.cli`).

Nothing here imports JAX.
"""

__version__ = "0.1.0"
