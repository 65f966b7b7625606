"""The PyTorch port never imports JAX: every module of
galileo_sdr_sim_tpu_torch imports with `jax` blocked, and none names it.
The machine with the GPU has no JAX at all."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import galileo_sdr_sim_tpu_torch
from galileo_sdr_sim_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "galileo_sdr_sim_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, BlockJax())
import galileo_sdr_sim_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print(len(names))
"""


_BLOCKED_FILE_IMPORTS = r"""
import ast, importlib, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, ".")
tree = ast.parse(open(sys.argv[1]).read())
mods = set()
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        mods.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module != "__future__":
        mods.add(node.module)
        pkg = importlib.import_module(node.module)
        # `from pkg import submodule` names a module the package may not load
        mods.update(f"{node.module}.{a.name}" for a in node.names if not hasattr(pkg, a.name))
for name in sorted(mods):
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print(len(mods))
"""


def _modules():
    return [
        m.name for m in pkgutil.walk_packages(
            galileo_sdr_sim_tpu_torch.__path__, "galileo_sdr_sim_tpu_torch."
        )
    ]


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(_modules()) - 1  # all but __main__


def test_no_module_names_jax():
    sources = list(PKG.rglob("*.py"))
    assert len(sources) >= 10
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "jaxlib"), (path, line)


@pytest.mark.parametrize(
    "path", ["chip_smoke.py", "tests/test_torch_cuda.py", "tests/_torch_dist_worker.py"]
)
def test_gpu_side_file_imports_no_jax(path):
    """What runs on the GPU machine, which has no JAX: every module the
    file imports, at top level or inside a function, imports with `jax`
    blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_FILE_IMPORTS, path],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 5


def test_bandlimit_port_stands_alone():
    """The port's band-limit module copies the JAX module's numpy parts
    instead of importing them: that module imports JAX."""
    code = (
        "import sys; import galileo_sdr_sim_tpu_torch.ops.bandlimit; "
        "assert 'galileo_sdr_sim_tpu.ops.bandlimit' not in sys.modules; "
        "assert 'jax' not in sys.modules; print('ok')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:1")
