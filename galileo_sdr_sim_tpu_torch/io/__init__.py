"""Streaming executor of the PyTorch port and its sinks (copies of the
JAX package's io/sinks.py, io/udp.py and io/native_fifo.py)."""
