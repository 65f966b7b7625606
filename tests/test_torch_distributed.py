"""Multi-process file generation in the port
(galileo_sdr_sim_tpu_torch/parallel/distributed.py and the CLI's
distributed mode) against the JAX package.

Two gloo CPU ranks (tests/_torch_dist_worker.py, mode "cli") run, once
for the module: the port's CLI with GALILEO_COORDINATOR set and
`--device cpu` (0.3 s, the default and the CBOC model; the two ranks of
one host form a (sat 2, time 1) mesh over the 16 uncompacted channels),
then `synth_batch_kp_distributed` + `write_segments` and
`generate_file_distributed` over a (sat 1, time 2) mesh.  Files are held
to the JAX package's `synth_batch_kp_distributed(engine="xla")` by the
engine bar (>= 99.9% of int16 values identical, every difference within
1000), and to the port's single-process output by the psum bar (>=
99.9% identical, no sample off by more than 1 LSB).
"""

import numpy as np
import pytest
import torch.distributed as dist

from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu.parallel import distributed as jdist
from galileo_sdr_sim_tpu_torch import cli
from galileo_sdr_sim_tpu_torch.harness import cboc_bar, engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.parallel import distributed as D
from galileo_sdr_sim_tpu_torch.parallel.mesh import check_placements

from _torch_parity import CPU, LLH, NAV, START, fixture_engine, run_ranks

NS = 10400
FULL = 260000  # the CLI's 0.1 s epochs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli_ranks")
    run_ranks("cli", 2, out)
    return out


def _jax_distributed(engine, nsamples: int) -> np.ndarray:
    """The JAX package's single-process distributed path (its global mesh
    over the 8 CPU devices: time 1, sat 8), epoch segments in order."""
    rows = []
    for batch in engine.batches(8):
        segs = jdist.synth_batch_kp_distributed(batch, nsamples, engine="xla")
        rows += [r for _, r in sorted(segs, key=lambda s: s[0])]
    return np.concatenate(rows)


def _port_single(engine, nsamples: int, block_epochs: int, cboc_weights: bool = True) -> np.ndarray:
    """The port's single-process kp output of every epoch of `engine`."""
    rows = []
    for batch in engine.batches(block_epochs):
        t = tkp.prepare_kp_inputs(batch, nsamples, device=CPU)
        if not cboc_weights:
            t.pop("cboc_ab", None)
        rows.append(tkp.packed_to_iq16(tkp.synth_kp_packed_ref(t, nsamples // 1300).numpy()))
    return np.concatenate(rows)


def _psum_bar(got, ref) -> None:
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (diff == 0).mean() >= D.PSUM_SAMPLE_IDENTITY_BOUND, (diff == 0).mean()
    assert diff.max() <= D.PSUM_MAX_LSB, diff.max()


def test_cli_distributed_matches_jax(ranks):
    got = np.fromfile(ranks / "cli_default.ishort", dtype=np.int16)
    n_epochs = len(fixture_engine(0.3))
    assert got.size == n_epochs * 2 * FULL
    ref = _jax_distributed(fixture_engine(0.3), FULL)
    bar = engine_bar(got, ref.reshape(-1))
    assert bar["ok"], bar
    _psum_bar(got, _port_single(fixture_engine(0.3), FULL, 8).reshape(-1))


def test_cli_distributed_cboc_drops_the_weights(ranks):
    """Reference behaviour reproduced: the JAX distributed path shards no
    CBOC weights, so `--model cboc` there emits the sign banks unweighted.
    The port's file matches JAX's, and matches the port's own stream only
    once the weights are dropped there too."""
    got = np.fromfile(ranks / "cli_cboc.ishort", dtype=np.int16)
    ref = _jax_distributed(fixture_engine(0.3, E1_CBOC), FULL).reshape(-1)
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    unweighted = _port_single(fixture_engine(0.3, E1_CBOC), FULL, 8, cboc_weights=False)
    _psum_bar(got, unweighted.reshape(-1))
    weighted = _port_single(fixture_engine(0.3, E1_CBOC), FULL, 8).reshape(-1)
    assert not cboc_bar(got, weighted)["ok"]
    assert (got != weighted).mean() > 0.5


def test_time_sharded_segments(ranks):
    """4 epochs over a (sat 1, time 2) mesh: each rank offset-writes its
    two epochs; the file is the single-process output."""
    got = np.fromfile(ranks / "segments.ishort", dtype=np.int16).reshape(4, 2 * NS)
    _psum_bar(got, _port_single(fixture_engine(0.5), NS, 4))
    batch = next(fixture_engine(0.5).batches(4))
    bar = engine_bar(got, jkp.synth_batch_kp_host(batch, NS, engine="xla"))
    assert bar["ok"], bar


def test_generate_file_distributed_pads_time_shards(ranks):
    """6 epochs in blocks of 3 over a time axis of 2: each block is padded
    to 4 epochs and the padding trimmed."""
    got = np.fromfile(ranks / "full.ishort", dtype=np.int16).reshape(6, 2 * NS)
    _psum_bar(got, _port_single(fixture_engine(0.7), NS, 3))


def test_host_layout():
    assert D.host_layout(["a"] * 4) == (1, 4)
    assert D.host_layout(["a", "a", "b", "b"]) == (2, 2)
    assert D.host_layout(["a", "b", "c"]) == (3, 1)
    with pytest.raises(ValueError, match="not contiguous"):
        D.host_layout(["a", "b", "a", "b"])
    with pytest.raises(ValueError, match="unequal"):
        D.host_layout(["a", "a", "b"])


def test_nccl_refuses_two_ranks_on_one_gpu():
    shared = [("h", "cuda:0"), ("h", "cuda:0")]
    with pytest.raises(ValueError, match="NCCL cannot run two ranks on one GPU"):
        check_placements(shared, 2, 1, "nccl")
    with pytest.raises(ValueError, match="time group"):
        check_placements(shared, 1, 2, "nccl")
    check_placements(shared, 2, 1, "gloo")  # gloo runs them
    check_placements([("h", "cuda:0"), ("h", "cuda:1")], 2, 1, "nccl")
    check_placements([("a", "cuda:0"), ("b", "cuda:0")], 2, 1, "nccl")
    check_placements([("h", "cpu"), ("h", "cpu")], 2, 1, "nccl")


def test_world_of_one_through_a_file_rendezvous(tmp_path, monkeypatch):
    monkeypatch.delenv(D.ENV_COORD, raising=False)
    assert D.maybe_initialize_from_env("gloo") is False
    D.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo", timeout_s=60)
    try:
        mesh = D.global_mesh("cpu")
        assert mesh.shape == {"sat": 1, "time": 1} and mesh.device == CPU
        with pytest.raises(ValueError, match="not a"):
            D.make_mesh(2, 1, CPU)
        batch = next(fixture_engine(0.3).batches(8))
        (e0, rows), = D.synth_batch_kp_distributed(batch, NS, mesh=mesh)
        assert e0 == 0
        np.testing.assert_array_equal(rows, _port_single(fixture_engine(0.3), NS, 8))
    finally:
        dist.destroy_process_group()


def test_cli_distributed_refuses_the_usrp_sink(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(D.ENV_COORD, f"file://{tmp_path / 'never'}")
    monkeypatch.setenv(D.ENV_NPROC, "2")
    monkeypatch.setenv(D.ENV_PID, "0")
    rc = cli.main(["-e", str(NAV), "-t", START, "-d", "0.3", "-l", ",".join(map(str, LLH)),
                   "-o", str(tmp_path / "x.ishort"), "--device", "cpu"])
    assert rc == 1
    assert "file sink only" in capsys.readouterr().out
    assert not dist.is_initialized()
