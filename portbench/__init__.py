"""Benchmark of the PyTorch/CUDA port (galileo_sdr_sim_tpu_torch): file
generation on one H100, cells named in BENCHMARK.json.  Entry point:
run.py.  Configurations in configs/, traffic mixes in traffic/, one
reader a metric in metrics/, the plain reference in reference/."""
