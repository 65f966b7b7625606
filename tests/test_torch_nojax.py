"""The PyTorch port never imports JAX nor the JAX package
`galileo_sdr_sim_tpu`: every module of galileo_sdr_sim_tpu_torch, and
every module the files that run on the GPU machine import, imports with
both blocked, and no source names either in an import.  The machine with
the GPU has no JAX at all; the port keeps its own copy of the host layer
it needs (its output is byte-identical to the route through the JAX
package's host layer)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import galileo_sdr_sim_tpu_torch
from galileo_sdr_sim_tpu.cli import _parse_time as jax_parse_time
from galileo_sdr_sim_tpu.cli import load_user_motion as jax_load_user_motion
from galileo_sdr_sim_tpu.rinex import read_rinex_v3 as jax_read_rinex_v3
from galileo_sdr_sim_tpu.scenario import PositionProvider as JaxPositionProvider
from galileo_sdr_sim_tpu.scenario import ScenarioEngine as JaxScenarioEngine
from galileo_sdr_sim_tpu.scenario import scenario_start_time as jax_scenario_start_time
from galileo_sdr_sim_tpu_torch._block_reference import BLOCKED
from galileo_sdr_sim_tpu_torch.device import resolve_device
from galileo_sdr_sim_tpu_torch.ops.synth_kp import (
    P_GRID, mu_in_envelope, packed_to_iq16, prepare_kp_inputs,
)
from galileo_sdr_sim_tpu_torch.ops.synth_kp_cuda import synth_kp_packed

from _torch_parity import CPU, LLH, NAV, START

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "galileo_sdr_sim_tpu_torch"
# files outside the package that run on the GPU machine
GPU_SIDE = ("chip_smoke.py", "tests/test_torch_cuda.py", "tests/_torch_dist_worker.py")

# the port's own import block (BLOCKED: the exact top-level names; the
# port's `galileo_sdr_sim_tpu_torch` passes), installed first in each
# subprocess
_BLOCK = r"""
import sys
from galileo_sdr_sim_tpu_torch._block_reference import install, loaded
install()
"""

_BLOCKED_IMPORT = _BLOCK + r"""
import importlib, pkgutil
import galileo_sdr_sim_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert not loaded(), loaded()
print(len(names))
"""


_BLOCKED_FILE_IMPORTS = _BLOCK + r"""
import ast, importlib
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
assert not loaded(), loaded()
print(len(mods))
"""


def _modules():
    return [
        m.name for m in pkgutil.walk_packages(
            galileo_sdr_sim_tpu_torch.__path__, "galileo_sdr_sim_tpu_torch."
        )
    ]


def test_every_module_imports_with_jax_blocked():
    """Every module of the port imports with JAX and the JAX package
    blocked, and leaves neither loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(_modules()) - 1  # all but __main__


def test_no_module_names_jax():
    """No import line of the port's sources, nor of the files that run on
    the GPU machine, names JAX or the JAX package."""
    sources = [*PKG.rglob("*.py"), *(REPO / f for f in GPU_SIDE)]
    assert len(sources) >= 30
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in BLOCKED, (path, line)


@pytest.mark.parametrize("path", GPU_SIDE)
def test_gpu_side_file_imports_no_jax(path):
    """What runs on the GPU machine, which has no JAX: every module the
    file imports, at top level or inside a function, imports with JAX and
    the JAX package blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_FILE_IMPORTS, path],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 5


def test_cli_with_the_reference_blocked_is_byte_identical(tmp_path):
    """The port's CLI on the CPU (1 s of the fixture scene, a one-row
    user-motion file, no bit relay) in a process where JAX and the JAX
    package cannot be imported writes exactly the bytes of the route
    before the port had its own host layer: the JAX package's
    ScenarioEngine batches through the port's plain kp engine."""
    um = tmp_path / "static.csv"
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    out = tmp_path / "port.ishort"
    argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "1", "-t", START,
            "-l", ",".join(str(v) for v in LLH), "-o", str(out), "--device", "cpu", "-u", str(um)]
    code = _BLOCK + (
        "import torch; torch.set_num_threads(2)\n"
        "from galileo_sdr_sim_tpu_torch import cli\n"
        f"rc = cli.main({argv!r})\n"
        "assert not loaded(), loaded()\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.fromfile(out, dtype=np.int16)

    nav = jax_read_rinex_v3(str(NAV))
    engine = JaxScenarioEngine(
        nav, JaxPositionProvider(trajectory=jax_load_user_motion(str(um))),
        jax_scenario_start_time(nav, jax_parse_time(START)), 1.0,
    )
    nsamples, blocks, cache = 200 * P_GRID, [], {}
    for batch in engine.batches(8):
        assert mu_in_envelope(batch.f_code)
        inputs = prepare_kp_inputs(batch, nsamples, pad_epochs=8, code_cache=cache, device=CPU)
        iq = packed_to_iq16(synth_kp_packed(inputs, 200).numpy())
        blocks.append(iq[: batch.f_code.shape[0], : 2 * nsamples].reshape(-1))
    ref = np.concatenate(blocks)
    assert got.size == ref.size > 0
    assert np.array_equal(got, ref)


def test_usrp_cli_with_the_reference_blocked(tmp_path):
    """The USRP path (no -U: the native ring, its consumer thread and
    UsrpSink) in a process where JAX and the JAX package cannot be
    imported, into the harness's stand-in `uhd`: the radio gets the bytes
    of the -U 1 file of the same command line, and the --trace-dir run
    writes its trace, with neither name loaded."""
    um = tmp_path / "static.csv"
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    argv = ["-e", str(NAV), "-b", "1", "-d", "0.3", "-t", START, "-u", str(um), "--device", "cpu"]
    out, trace = tmp_path / "file.ishort", tmp_path / "trace"
    code = _BLOCK + (
        "import hashlib; import torch; torch.set_num_threads(2)\n"
        "from galileo_sdr_sim_tpu_torch import cli, harness\n"
        "uhd = sys.modules['uhd'] = harness.stand_in_uhd()\n"
        f"assert cli.main({argv!r}) == 0\n"
        f"assert cli.main({argv!r} + ['-U', '1', '-o', {str(out)!r}, '--trace-dir', {str(trace)!r}]) == 0\n"
        "(radio,) = uhd.radios\n"
        f"assert radio.stream.digest.hexdigest() == hashlib.sha256(open({str(out)!r}, 'rb').read()).hexdigest()\n"
        "assert radio.stream.samples == 2 * 260000 and radio.stream.md.end_of_burst\n"
        "assert not loaded(), loaded()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.splitlines()[-1] == "ok", proc.stderr[-3000:]
    assert len(list(trace.glob("*.pt.trace.json"))) == 1


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
