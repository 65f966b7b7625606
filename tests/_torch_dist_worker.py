"""One rank of the PyTorch port's multi-process tests (imports no JAX).

    python tests/_torch_dist_worker.py MODE INIT WORLD RANK OUTDIR

INIT is a torch.distributed init_method URL (file://... in the tests, so
that parallel test runs never race for a TCP port); every rendezvous and
collective times out after TIMEOUT_S.  Each mode writes its results as
.npy files named <case>_r<rank>.npy into OUTDIR and prints
"RANK <rank> OK" at the end:

* mesh (4 ranks, gloo, CPU): `mesh.synth_batch_kp_sharded` at (n_sat,
  n_time) = (2, 2), (4, 1), (1, 4) and a CBOC block at (2, 2), and
  `mesh.synth_batch_sharded` in lut512 at (2, 2) and (1, 4), on the first
  B = 8 block of the fixture scene at NS = 10400 samples an epoch;
* cli (2 ranks, gloo, CPU): the port's CLI in distributed mode with
  `--device cpu` (0.3 s, default and --model cboc, each with its own
  rendezvous file), then `synth_batch_kp_distributed` + `write_segments`
  and `generate_file_distributed` (blocks of 3) over a (sat 1, time 2)
  mesh;
* nccl_shared (2 ranks, NCCL, one GPU): `make_mesh` must refuse two ranks
  of one sat group on cuda:0; prints "REFUSED" with the error;
* card (2 ranks, gloo on CUDA tensors, one GPU; run by chip_smoke.py):
  `generate_file_distributed` over the host's (sat 2, time 1) mesh, 3 s
  of the fixture scene at full width (16 uncompacted channels, 8 a
  rank) into OUTDIR/two_rank.ishort; the same 3 s over a (sat 1, time 2)
  mesh through `synth_batch_kp_distributed` + `write_segments` into
  OUTDIR/time2.ishort; the gloo all-reduce of one B = 8 block's float32
  partial; a timed 10 s run.  Prints one line "CARD <json>" a rank.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# JAX and the JAX package are blocked before the rest of the port loads
from galileo_sdr_sim_tpu_torch._block_reference import install  # noqa: E402

install()

from galileo_sdr_sim_tpu_torch import cli  # noqa: E402
from galileo_sdr_sim_tpu_torch.harness import FIXTURE_LLH, FIXTURE_START, fixture_engine  # noqa: E402
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC  # noqa: E402
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda  # noqa: E402
from galileo_sdr_sim_tpu_torch.parallel import distributed as D  # noqa: E402
from galileo_sdr_sim_tpu_torch.parallel import mesh as M  # noqa: E402
from galileo_sdr_sim_tpu_torch.profiling import Timer  # noqa: E402

NAV = REPO / "tests" / "data" / "obs_fixture_nav.rnx"
NS = 10400  # one (8 x 1300) row cycle an epoch
TILE = 1300  # direct engine: 8 tiles an epoch, split over 1, 2 or 4 ranks
TIMEOUT_S = 120.0
KP_MESHES = ((2, 2), (4, 1), (1, 4))
LUT_MESHES = ((2, 2), (1, 4))
CPU = torch.device("cpu")


def _save(outdir: Path, name: str, rank: int, arr) -> None:
    np.save(outdir / f"{name}_r{rank}.npy", np.asarray(arr))


def _init(init: str, world: int, rank: int, backend: str = "gloo") -> None:
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def run_mesh(init: str, world: int, rank: int, outdir: Path) -> None:
    _init(init, world, rank)
    batch = next(fixture_engine(NAV, 1.0).batches(8))
    cboc_batch = next(fixture_engine(NAV, 1.0, E1_CBOC).batches(8))
    for n_sat, n_time in KP_MESHES:
        mesh = M.make_mesh(n_sat, n_time, CPU)
        out = M.synth_batch_kp_sharded(batch, mesh, nsamples=NS, pad_epochs=8)
        _save(outdir, f"kp_{n_sat}x{n_time}", rank, out)
    mesh = M.make_mesh(2, 2, CPU)
    out = M.synth_batch_kp_sharded(cboc_batch, mesh, nsamples=NS, pad_epochs=8)
    _save(outdir, "kp_cboc_2x2", rank, out)
    for n_sat, n_time in LUT_MESHES:
        mesh = M.make_mesh(n_sat, n_time, CPU)
        out = M.synth_batch_sharded(batch, mesh, tile=TILE, mode="lut512", nsamples=NS)
        _save(outdir, f"lut_{n_sat}x{n_time}", rank, out)
    dist.destroy_process_group()


def run_cli(init: str, world: int, rank: int, outdir: Path) -> None:
    # the launcher writes OUTDIR/static.csv, a one-row motion file that
    # keeps the run off the UDP position port
    um = outdir / "static.csv"
    llh = ",".join(str(v) for v in FIXTURE_LLH)
    os.environ.update({D.ENV_NPROC: str(world), D.ENV_PID: str(rank)})
    for label, options in (("default", []), ("cboc", ["--model", "cboc"])):
        os.environ[D.ENV_COORD] = f"{init}_{label}"
        rc = cli.main([
            "-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.3", "-t", FIXTURE_START,
            "-l", llh, "-o", str(outdir / f"cli_{label}.ishort"), "-u", str(um),
            "--device", "cpu", *options,
        ])
        if rc != 0:
            raise SystemExit(f"cli.main {label} returned {rc}")
        if dist.is_initialized():
            raise SystemExit("the CLI left its process group initialized")
    del os.environ[D.ENV_COORD]

    _init(f"{init}_mesh", world, rank)
    mesh = M.make_mesh(1, 2, CPU)
    batch = next(fixture_engine(NAV, 0.5).batches(4))
    segments = D.synth_batch_kp_distributed(batch, NS, mesh=mesh)
    if [e0 for e0, _ in segments] != [2 * rank] or segments[0][1].shape != (2, 2 * NS):
        raise SystemExit(f"rank {rank} segments {[(e0, r.shape) for e0, r in segments]}")
    seg_file = outdir / "segments.ishort"
    if rank == 0:
        D.presize(seg_file, NS, total_epochs=4)
    D.barrier("presize")
    D.write_segments(seg_file, segments, NS)
    D.barrier("written")
    n = D.generate_file_distributed(
        fixture_engine(NAV, 0.7), outdir / "full.ishort", block_epochs=3, nsamples=NS, mesh=mesh
    )
    if n != 6:
        raise SystemExit(f"generate_file_distributed wrote {n} epochs, want 6")
    dist.destroy_process_group()


def run_nccl_shared(init: str, world: int, rank: int, outdir: Path) -> None:
    _init(init, world, rank, backend="nccl")
    try:
        M.make_mesh(world, 1, torch.device("cuda", 0))
    except ValueError as err:
        print(f"REFUSED {err}", flush=True)
    else:
        raise SystemExit("make_mesh put two NCCL ranks on one GPU")
    finally:
        dist.destroy_process_group()


def run_card(init: str, world: int, rank: int, outdir: Path) -> None:
    _init(init, world, rank)  # gloo: NCCL cannot put two ranks on one GPU
    mesh = D.global_mesh("cuda")
    synth_kp_cuda.reset_counts()
    epochs = D.generate_file_distributed(fixture_engine(NAV, 3.0), outdir / "two_rank.ishort",
                                         mesh=mesh)
    counts = dict(synth_kp_cuda.launch_counts)

    time_mesh = M.make_mesh(1, world, mesh.device)
    seg_file = outdir / "time2.ishort"
    if rank == 0:
        D.presize(seg_file, 260000, total_epochs=len(fixture_engine(NAV, 3.0)))
    D.barrier("presize")
    base = 0
    for batch in fixture_engine(NAV, 3.0).batches(8):
        D.write_segments(seg_file, D.synth_batch_kp_distributed(batch, 260000, time_mesh),
                         260000, base_epoch=base)
        base += batch.f_code.shape[0]
    D.barrier("written")

    # the all-reduce of one B = 8 block's partial, host clock around a
    # synchronized call (gloo stages CUDA tensors through host memory)
    acc = torch.ones((8, 260000, 2), dtype=torch.float32, device=mesh.device)
    times = []
    for rep in range(13):
        D.barrier("allreduce")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(acc, group=mesh.sat_group)
        torch.cuda.synchronize()
        if rep >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    if not torch.all(acc == 2.0 ** 13):
        raise SystemExit("the gloo all-reduce of CUDA tensors summed wrong")

    timer = Timer()
    D.barrier("timed")
    t0 = time.perf_counter()
    n10 = D.generate_file_distributed(fixture_engine(NAV, 10.0), outdir / "two_rank10.ishort",
                                      mesh=mesh, timer=timer)
    wall = time.perf_counter() - t0
    print("CARD " + json.dumps({
        "rank": rank, "mesh": mesh.shape, "device": str(mesh.device), "epochs": epochs,
        "counts": counts, "allreduce_ms": sorted(times), "e2e_epochs": n10, "e2e_wall_s": wall,
        "e2e_samples_per_sec": n10 * 260000 / wall, "stages": timer.report(),
    }), flush=True)
    dist.destroy_process_group()


def main() -> None:
    mode, init, world, rank, outdir = sys.argv[1:6]
    torch.set_num_threads(1)  # several ranks share the test machine's cores
    run = {"mesh": run_mesh, "cli": run_cli, "nccl_shared": run_nccl_shared,
           "card": run_card}[mode]
    run(init, int(world), int(rank), Path(outdir))
    print(f"RANK {rank} OK", flush=True)


if __name__ == "__main__":
    main()
