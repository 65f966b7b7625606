"""The port's gather probe (ops/gather_probe.py) on the CPU: its plain
version against numpy's `take_along_axis` (the tool's own oracle,
tools/probe_pallas_gather.py:33-36) and against the tool's Pallas kernel
body run in interpret mode, on the tool's seven probes; the wrapper's
refusals; 0 for an index outside the table; `main()`.  The CUDA kernel
itself is held to `torch.take_along_dim` in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from galileo_sdr_sim_tpu_torch.ops import gather_probe

PROBES = gather_probe.PROBES


def _tool_probe(tab: np.ndarray, idx: np.ndarray, axis: int) -> np.ndarray:
    """The tool's `main.probe.k` (tools/probe_pallas_gather.py:23-32),
    rebuilt here because the tool nests it in `main()`, under the Pallas
    interpreter."""

    def k(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=axis)

    out = pl.pallas_call(
        k,
        out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx))
    return np.asarray(out)


def _inputs(shape, maxidx, seed=0):
    return gather_probe.probe_inputs(shape, maxidx, torch.Generator().manual_seed(seed))


def test_probes_are_the_tools():
    assert [(s, m, a) for s, m, a in PROBES] == [
        ((8, 128), 128, 1), ((16, 128), 128, 1), ((8, 256), 256, 1), ((16, 512), 512, 1),
        ((16, 8192), 128, 1), ((16, 8192), 8192, 1), ((128, 128), 128, 0),
    ]


@pytest.mark.parametrize("shape, maxidx, axis", PROBES)
def test_plain_matches_numpy_and_the_pallas_probe(shape, maxidx, axis):
    tab, idx = _inputs(shape, maxidx)
    assert tab.dtype == idx.dtype == torch.int32 and tuple(tab.shape) == shape
    assert int(tab.min()) >= -3 and int(tab.max()) < 4
    assert int(idx.min()) >= 0 and int(idx.max()) < maxidx
    got = gather_probe.take_along_axis(tab, idx, axis)
    assert got.dtype == torch.int32 and got.shape == tab.shape
    want = np.take_along_axis(tab.numpy(), idx.numpy(), axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_tool_probe(tab.numpy(), idx.numpy(), axis), want)


def test_inputs_follow_the_seed():
    a = _inputs((16, 512), 512, seed=5)
    b = _inputs((16, 512), 512, seed=5)
    c = _inputs((16, 512), 512, seed=6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_wrapper_refusals():
    tab, idx = _inputs((8, 128), 128)
    with pytest.raises(ValueError, match="int32"):
        gather_probe.take_along_axis(tab.long(), idx, 1)
    with pytest.raises(ValueError, match="int32"):
        gather_probe.take_along_axis(tab, idx.long(), 1)
    with pytest.raises(ValueError, match="2-D"):
        gather_probe.take_along_axis(tab.reshape(-1), idx.reshape(-1), 0)
    with pytest.raises(ValueError, match="one shape"):
        gather_probe.take_along_axis(tab, idx[:4], 1)
    with pytest.raises(ValueError, match="axis"):
        gather_probe.take_along_axis(tab, idx, 2)
    with pytest.raises(ValueError, match="contiguous"):
        gather_probe.take_along_axis(tab.t(), idx.t(), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_probe.take_along_axis(tab.to("meta"), idx.to("meta"), 1)


@pytest.mark.parametrize("shape, axis", [((8, 128), 1), ((128, 128), 0)])
def test_index_outside_the_table_gives_zero(shape, axis):
    """The contract the kernel shares with its plain version: 0 where an
    index lies outside [0, n), the gather elsewhere."""
    tab, idx = _inputs(shape, 128, seed=2)
    bad = torch.tensor([-1, shape[axis], 2**31 - 1, -(2**31)], dtype=torch.int32)
    idx[3, :4] = bad
    got = gather_probe.take_along_axis(tab, idx, axis).numpy()
    inside = ((idx >= 0) & (idx < shape[axis])).numpy()
    want = np.take_along_axis(tab.numpy(), np.where(inside, idx.numpy(), 0), axis=axis)
    np.testing.assert_array_equal(got, np.where(inside, want, 0))
    assert not got[3, :4].any() and inside.sum() == idx.numel() - 4


def test_cpu_tensors_take_the_plain_version():
    tab, idx = _inputs((16, 128), 128)
    before = gather_probe.launch_count
    gather_probe.take_along_axis(tab, idx, 1)
    assert gather_probe.launch_count == before


def test_main_on_the_cpu(capsys):
    assert gather_probe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(": CORRECT") for line in lines) == len(PROBES)
    assert "(128, 128) axis=0 maxidx=128: CORRECT" in lines


def test_main_reports_a_wrong_result_and_raises(monkeypatch, capsys):
    real = gather_probe.take_along_axis
    monkeypatch.setattr(gather_probe, "take_along_axis", lambda t, i, a: real(t, i, a) + 1)
    assert gather_probe.main(["--device", "cpu"]) == 1
    assert "WRONG RESULT" in capsys.readouterr().out

    def broken(tab, idx, axis):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(gather_probe, "take_along_axis", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        gather_probe.main(["--device", "cpu"])
