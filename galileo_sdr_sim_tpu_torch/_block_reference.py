"""An import block on JAX and on the JAX package `galileo_sdr_sim_tpu`.

`install()` puts a finder at the head of `sys.meta_path` that refuses
the top-level names in BLOCKED (the exact names: the port's own
`galileo_sdr_sim_tpu_torch` passes).  chip_smoke.py, the rank worker
tests/_torch_dist_worker.py and the no-JAX tests install it before they
import the rest of the port, so a leftover import of the reference fails
there instead of passing because the reference package lies in the same
checkout.  Importing this module installs nothing.
"""

from __future__ import annotations

import sys

BLOCKED = ("jax", "jaxlib", "galileo_sdr_sim_tpu")


class BlockReference:
    """A meta-path finder that raises ImportError for a BLOCKED name."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port imports nothing of JAX or the JAX package")
        return None


def install() -> None:
    """Block the names in BLOCKED in this process (once)."""
    if not any(isinstance(f, BlockReference) for f in sys.meta_path):
        sys.meta_path.insert(0, BlockReference())


def loaded() -> list[str]:
    """The modules of a BLOCKED name this process has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
