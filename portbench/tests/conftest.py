"""The benchmark's own tests (python -m pytest portbench/tests from the
checkout's root); the checkout's root leads the import path."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

# the program's plain engines run these tests; a few threads run them fastest
torch.set_num_threads(4)
