"""Streaming executor of the PyTorch port (sinks are reused from
galileo_sdr_sim_tpu.io.sinks)."""
