"""The port's gather probe (ops/gather_probe.py) on the CPU: its plain
version against numpy's `take_along_axis` (the tool's own oracle,
tools/probe_pallas_gather.py:33-36) and against the tool's Pallas kernel
body run in interpret mode, on the tool's seven probes; the wrapper's
refusals; 0 for an index outside the table; `main()`; and the kernel's
tiling (launch geometry, the slice of the table a block stages, what its
wrapper refuses), emulated block by block in numpy against
`np.take_along_axis`.  The CUDA kernel itself is held to
`torch.take_along_dim` in tests/test_torch_cuda.py."""

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


# --- the kernel's tiling, emulated block by block -----------------------------


def _tiled_gather(tab: np.ndarray, idx: np.ndarray, axis: int) -> tuple:
    """The CUDA kernel's work in numpy, one block of `launch_geometry`'s
    grid at a time: stage the block's slice of the table (`tile_bytes` of
    it), read the block's indices four to a thread, gather from the slice
    alone, 0 for an index outside the table -> (out, times each output
    was written)."""
    rows, cols = tab.shape
    (gx, gy, gz), threads = gather_probe.launch_geometry(rows, cols, axis)
    assert gz == 1 and threads == gather_probe.THREADS
    out = np.full(tab.shape, 99, np.int32)
    written = np.zeros(tab.shape, np.int64)
    for by in range(gy):
        for bx in range(gx):
            if axis == 1:
                tile = tab[by].copy()  # the whole row
                c0, c1 = bx * gather_probe.OUT_TILE, min(cols, (bx + 1) * gather_probe.OUT_TILE)
                where = (slice(by, by + 1), slice(c0, c1))
                j = idx[where]
                inside = (j >= 0) & (j < cols)
                got = np.where(inside, tile[np.where(inside, j, 0)], 0)
            else:
                c0, c1 = bx * gather_probe.AX0_COLS, min(cols, (bx + 1) * gather_probe.AX0_COLS)
                tile = tab[:, c0:c1].copy()  # every row of the block's columns
                r0, r1 = by * gather_probe.AX0_ROWS, min(rows, (by + 1) * gather_probe.AX0_ROWS)
                where = (slice(r0, r1), slice(c0, c1))
                j = idx[where]
                inside = (j >= 0) & (j < rows)
                got = np.where(inside, tile[np.where(inside, j, 0), np.arange(c1 - c0)], 0)
            assert tile.nbytes <= gather_probe.tile_bytes(rows, cols, axis)
            out[where] = got
            written[where] += 1
    return out, written


@pytest.mark.parametrize("shape, maxidx, axis", [
    *PROBES, ((40, 72), 40, 0), ((40, 72), 72, 1), ((3, 2052), 2052, 1), ((130, 36), 130, 0),
])
def test_tiling_covers_every_output_once_and_gathers_in_the_tile(shape, maxidx, axis):
    """The seven probe shapes and four ragged ones (partial column tiles,
    partial row chunks, a row longer than one block's outputs): every
    output is written by exactly one block, from that block's slice."""
    tab, idx = (t.numpy() for t in _inputs(shape, maxidx, seed=7))
    out, written = _tiled_gather(tab, idx, axis)
    assert (written == 1).all()
    np.testing.assert_array_equal(out, np.take_along_axis(tab, idx, axis=axis))


def test_tiling_geometry_of_the_probes():
    geometry = [gather_probe.launch_geometry(*shape, axis)[0] for shape, _, axis in PROBES]
    assert geometry == [(1, 8, 1), (1, 16, 1), (1, 8, 1), (1, 16, 1), (8, 16, 1), (8, 16, 1),
                        (4, 4, 1)]
    sizes = [gather_probe.tile_bytes(*shape, axis) for shape, _, axis in PROBES]
    assert sizes == [512, 512, 1024, 2048, 32768, 32768, 16384]
    assert max(sizes) <= gather_probe.SMEM_LIMIT


def test_tiled_gather_gives_zero_outside_the_table():
    for shape, axis in (((8, 128), 1), ((128, 128), 0)):
        tab, idx = (t.numpy() for t in _inputs(shape, 128, seed=2))
        idx[3, :4] = [-1, shape[axis], 2**31 - 1, -(2**31)]
        out, _ = _tiled_gather(tab, idx, axis)
        want = gather_probe.take_along_axis_ref(torch.from_numpy(tab), torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(out, want.numpy())
        assert not out[3, :4].any()


def test_kernel_refuses_what_its_tiles_do_not_take():
    """Rows move 16 bytes at a time, and a block's slice must fit its
    shared memory: the checks a CUDA call makes before it launches."""
    tab, idx = _inputs((8, 128), 128)
    gather_probe._check_tiles(tab, idx, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather_probe._check_tiles(tab[:, :126].contiguous(), idx[:, :126].contiguous(), 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_probe._check_tiles(tab.reshape(-1)[4:132].reshape(1, 128)[:, 1:125], idx, 1)
    wide = torch.zeros((1, 4 * 60000), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        gather_probe._check_tiles(wide, wide, 1)
    tall = torch.zeros((2000, 32), dtype=torch.int32)
    gather_probe._check_tiles(tall, tall, 1)
    with pytest.raises(ValueError, match="shared memory"):
        gather_probe._check_tiles(tall, tall, 0)
