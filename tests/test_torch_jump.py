"""The jump scene through both CLIs on the CPU: a user-motion file that
stays at the fixture site and then jumps 1370 km south, so that the block
holding the jump leaves the factorized engine's code-Doppler envelope and
goes through the direct fallback (`io/stream.py`, `ops/synth.py`).

The port's `cli.main --device cpu` against the JAX package's `cli.main` on
the same nav file, start time and motion file.  The scene is the one
`chip_smoke.py` runs on the card for 32 s (harness.JUMP_ROWS), cut here to
what a CPU test can make: 2.4 s with the jump after 1.2 s (three blocks of
eight epochs: kp, fallback, kp) in the default float mode, and 1.2 s with
the jump after 0.5 s in `--mode lut512` (every block through the direct
engine, one second of CPU an epoch).  Float mode: the kp blocks and the
fallback block are each held to the engine bar (>= 99.9% of int16 values
identical, every difference within 4 * LUT_AMPLITUDE = 1000: float32
sin/cos of two libraries and one chip-edge timing ULP).  lut512 mode: the
files are byte-identical (integer carrier table, no float rounding in the
output)."""

import numpy as np
import pytest

from galileo_sdr_sim_tpu.cli import main as jax_main
from galileo_sdr_sim_tpu_torch import cli, harness

from _torch_parity import LLH, NAV, START


def _argv(motion: str, duration: float, out) -> list:
    return ["-e", str(NAV), "-U", "1", "-b", "1", "-d", str(duration), "-t", START,
            "-l", ",".join(str(v) for v in LLH), "-u", motion, "-o", str(out)]


def test_jump_motion_file_is_the_host_layer_case(tmp_path):
    """harness.write_jump_motion writes the `motion_jump` trajectory of
    tests/test_torch_host_layer.py: 150 rows at the site, 170 after."""
    path = harness.write_jump_motion(tmp_path / "jump.csv")
    traj = cli.load_user_motion(path)
    assert traj.shape == (320, 3)
    assert np.array_equal(traj[:150], np.tile(harness.FIXTURE_LLH, (150, 1)))
    assert np.array_equal(traj[150:], np.tile(harness.JUMP_LLH, (170, 1)))
    assert harness.JUMP_SECONDS == 32.0 and harness.JUMP_LLH == (30.0, -71.0589, 2.0)


def test_jump_scene_float_mode_matches_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    motion = harness.write_jump_motion(tmp_path / "jump.csv", rows=(12, 20))
    port, ref = tmp_path / "port.ishort", tmp_path / "jax.ishort"
    assert cli.main([*_argv(motion, 2.4, port), "--device", "cpu"]) == 0
    assert jax_main(_argv(motion, 2.4, ref)) == 0
    blocks = harness.jump_scene_blocks(NAV, motion, 2.4)
    assert [(b["first"], b["epochs"], b["fallback"]) for b in blocks] == [
        (0, 8, False), (8, 8, True), (16, 7, False)]
    got = harness.compare_jump_files(port, ref, blocks)
    assert got["complete"] and got["epochs"] == 23
    assert (got["kp_blocks"], got["fallback_blocks"]) == (2, 1)
    assert got["kp"]["ok"], got["kp"]
    assert got["fallback"]["ok"], got["fallback"]
    # the file is a signal: the first block acquires every PRN at its Doppler
    for a in harness.acquire_block(port, blocks[0]):
        assert a["metric"] >= 8.0 and abs(a["doppler"] - a["f_carr"]) <= 100.0, a
    # and the jump is in it: the code phase after the jump is not the static scene's
    static = harness.write_jump_motion(tmp_path / "static.csv", rows=(32, 0))
    moved = harness.jump_scene_blocks(NAV, motion, 2.4)[2]["f_carr"]
    stayed = harness.jump_scene_blocks(NAV, static, 2.4)[2]["f_carr"]
    assert np.abs(moved - stayed).max() > 100.0


def test_jump_scene_lut512_mode_is_byte_identical_to_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    motion = harness.write_jump_motion(tmp_path / "jump.csv", rows=(5, 11))
    port, ref = tmp_path / "port.ishort", tmp_path / "jax.ishort"
    options = ["--mode", "lut512", "--block-epochs", "4"]
    assert cli.main([*_argv(motion, 1.2, port), "--device", "cpu", *options]) == 0
    assert jax_main([*_argv(motion, 1.2, ref), *options]) == 0
    got, want = np.fromfile(port, dtype=np.int16), np.fromfile(ref, dtype=np.int16)
    assert got.size == want.size == 11 * 2 * 260000
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 0.9 * got.size


def test_compare_jump_files_reports_a_short_file_and_a_fault(tmp_path):
    """The comparison the card's run is held by: a file that lacks an epoch
    is not complete; a fault in the fallback block fails that route only."""
    ns = 1000
    blocks = [{"first": 0, "epochs": 2, "fallback": False}, {"first": 2, "epochs": 1, "fallback": True}]
    rng = np.random.default_rng(0)
    ref = rng.integers(-2000, 2000, 3 * 2 * ns).astype(np.int16)
    ref.tofile(tmp_path / "ref.ishort")
    ref[: 2 * 2 * ns].tofile(tmp_path / "short.ishort")
    assert not harness.compare_jump_files(tmp_path / "short.ishort", tmp_path / "ref.ishort",
                                          blocks, ns)["complete"]
    bad = ref.copy()
    bad[2 * 2 * ns + 7] += 1500
    bad.tofile(tmp_path / "bad.ishort")
    got = harness.compare_jump_files(tmp_path / "bad.ishort", tmp_path / "ref.ishort", blocks, ns)
    assert got["complete"] and got["kp"] == {"match": 1.0, "max_abs_err": 0, "ok": True}
    assert not got["fallback"]["ok"] and got["fallback"]["max_abs_err"] == 1500
    same = harness.compare_jump_files(tmp_path / "ref.ishort", tmp_path / "ref.ishort", blocks, ns)
    assert same["kp"]["ok"] and same["fallback"]["ok"] and same["fallback_blocks"] == 1
