"""Device selection for the PyTorch port.

Every function of the port takes an explicit `torch.device`; there is no
global device state.  `resolve_device` turns the CLI's `--device` string
into one and refuses to carry on silently on the CPU when a GPU was
asked for.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' / 'cuda:N' -> that GPU (raises when none is present);
    'cpu' -> the CPU, only when asked for by name (tests, debugging)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available "
                "(pass --device cpu to run the plain PyTorch engines)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise RuntimeError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
