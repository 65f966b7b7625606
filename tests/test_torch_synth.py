"""Direct engine of the PyTorch port (ops/synth.py) against the JAX
package's XLA direct engine: `lut512` exactly equal; `float` held to the
engine bar (>= 99.9% of int16 values identical, every difference within
4 * LUT_AMPLITUDE = 1000).  Small sample counts keep the gathers cheap."""

import dataclasses

import numpy as np
import pytest

from galileo_sdr_sim_tpu.ops import synth as jsynth
from galileo_sdr_sim_tpu_torch.harness import engine_bar
from galileo_sdr_sim_tpu_torch.ops import synth as tsynth

from _torch_parity import CPU, fixture_batch

NS = 6144  # samples per epoch (not a whole number of tiles)
TILE = 512


@pytest.fixture(scope="module")
def batch():
    return fixture_batch(block_epochs=3)


def _teleport(batch):
    """The same scene with a code Doppler far outside the kp envelope in
    one channel (what a live-position teleport gives for one epoch)."""
    f_code = batch.f_code.copy()
    f_code[1, 0] += 40.0
    return dataclasses.replace(batch, f_code=f_code)


def _both(batch, mode, pad_epochs=None):
    j = jsynth.prepare_device_inputs(batch, TILE, NS, pad_epochs=pad_epochs)
    t = tsynth.prepare_device_inputs(batch, TILE, NS, pad_epochs=pad_epochs, device=CPU)
    ref = np.asarray(jsynth.synth_block(j, tile=TILE, mode=mode))
    got = tsynth.synth_block(t, tile=TILE, mode=mode).numpy()
    return j, t, got, ref


def test_prepare_device_inputs_matches_jax(batch):
    j, t, _, _ = _both(batch, "lut512", pad_epochs=4)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)


@pytest.mark.parametrize("scene", ["fixture", "teleport"])
def test_lut512_is_exact(batch, scene):
    b = batch if scene == "fixture" else _teleport(batch)
    _, _, got, ref = _both(b, "lut512")
    assert got.dtype == np.int16 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scene", ["fixture", "teleport"])
def test_float_meets_engine_bar(batch, scene):
    b = batch if scene == "fixture" else _teleport(batch)
    _, _, got, ref = _both(b, "float")
    assert got.shape == ref.shape == (3, 2 * tsynth.padded_samples(NS, TILE))
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got[:, : 2 * NS]) > 0.9 * 2 * NS * 3


def test_code_cache_reuses_slabs(batch):
    cache = {}
    a = tsynth.prepare_device_inputs(batch, TILE, NS, code_cache=cache, device=CPU)
    b = tsynth.prepare_device_inputs(batch, TILE, NS, code_cache=cache, device=CPU)
    assert a["codes_b"] is b["codes_b"] and a["codes_c"] is b["codes_c"]


def test_unknown_mode_rejected(batch):
    t = tsynth.prepare_device_inputs(batch, TILE, NS, device=CPU)
    with pytest.raises(ValueError, match="mode"):
        tsynth.synth_block(t, tile=TILE, mode="lut1024")
