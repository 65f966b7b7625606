"""The band-limited CBOC mode (ops/bandlimit.py) against the JAX package.

* The numpy parts (taps, polyphase kernel, phase shift) equal the JAX
  module's exactly.
* The filter, given the same int16 phase stack and history, is held to
  the JAX filter at >= 99.9% of int16 values identical and every
  difference within 2 (float32 sums straddling an integer truncate
  differently: the class of tests/test_bandlimit.py:91-94); the new
  overlap state is a copy and equal exactly.
* The phase stack (one host prep and one kernel call of 12 x B epochs)
  equals the 12 calls of B epochs it replaced, bit for bit, and is a
  view of the one call's output.
* Whole blocks: the phase stacks meet `cboc_bar`, and each output
  sample obeys |y_port - y_jax| <= (|K| * |x_port - x_jax|) + 2 with K
  the polyphase kernel (`bandlimit_bar`): one chip-edge flip of 1000 in
  one phase moves an output by up to 1000 * max|K| ~ 83, so no flat
  share bar fits this stage.
Small sizes: 10400-sample epochs (n_k = 8), blocks of <= 4 epochs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.ops import bandlimit as jbl
from galileo_sdr_sim_tpu.ops import synth_kp as jkp
from galileo_sdr_sim_tpu_torch.harness import BL_SLACK, bandlimit_bar, cboc_bar
from galileo_sdr_sim_tpu_torch.ops import bandlimit as tbl
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

from _torch_parity import CPU, fixture_engine

NS = 8 * 1300  # 10400-sample test epochs


@pytest.fixture(scope="module")
def blocks():
    """Three blocks of the CBOC fixture scene: 4, 4 and 2 epochs."""
    out = list(fixture_engine(1.0, model=E1_CBOC).batches(4))[:3]
    out[2] = first_epochs(out[2], 2)
    return out


def first_epochs(batch, n):
    """The batch's first n epochs."""
    return dataclasses.replace(
        batch, **{f: getattr(batch, f)[:n] for f in (
            "grx_sec", "f_carr", "f_code", "code_phase0", "carr_phase0",
            "sym_win", "pilot_win", "gain")},
    )


def twelve_calls(batch, pad, cache, apply_gain):
    """The 12 phase streams as one host prep and one int16 call per
    phase, (12, pad, 2N) int16: the loop the phase stack replaced."""
    return torch.stack([
        synth_kp_cuda.synth_kp_int16(
            tkp.prepare_kp_inputs(tbl.phase_shift_batch(batch, j), NS, pad_epochs=pad,
                                  code_cache=cache, apply_gain=apply_gain, device=CPU),
            NS // 1300,
        )
        for j in range(tbl.OS)
    ])


def jax_phases(batch, apply_gain=False, pad=4):
    """The JAX package's 12 phase streams of a block, (12, pad, 2N) int16."""
    return np.stack([
        np.asarray(jkp.synth_block_kp(
            jkp.prepare_kp_inputs(
                jbl.phase_shift_batch(batch, j), NS, pad_epochs=pad, apply_gain=apply_gain
            ),
            n_k=NS // 1300, engine="xla",
        ))
        for j in range(jbl.OS)
    ])


def test_numpy_parts_equal_jax(blocks):
    np.testing.assert_array_equal(tbl.lowpass_taps(), jbl.lowpass_taps())
    np.testing.assert_array_equal(tbl.polyphase_kernel(), jbl.polyphase_kernel())
    assert (tbl.OS, tbl.TPP, tbl.M, tbl.D, tbl.V0) == (jbl.OS, jbl.TPP, jbl.M, jbl.D, jbl.V0)
    kern = tbl.polyphase_kernel()
    # the per-sample bound of the stream bar rests on these two numbers
    assert abs(np.abs(kern).max() - 0.0834) < 1e-4 and abs(np.abs(kern).sum() - 1.98) < 1e-2
    for j in range(tbl.OS):
        got, ref = tbl.phase_shift_batch(blocks[0], j), jbl.phase_shift_batch(blocks[0], j)
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name), getattr(ref, f.name), err_msg=f.name)
    state = tbl.initial_state(CPU)
    assert state.dtype == torch.float32 and tuple(state.shape) == (2, 12, 32) and not state.any()
    np.testing.assert_array_equal(state.numpy(), np.asarray(jbl.initial_state()))


@pytest.mark.parametrize("n_real", [3, 2])
def test_filter_matches_jax(n_real):
    """Seeded int16 phase streams and a non-zero history through both
    filters; a partial block (n_real < B) takes the history at its last
    real sample."""
    rng = np.random.default_rng(7 + n_real)
    stacked = rng.integers(-2500, 2500, (12, 3, 2 * NS)).astype(np.int16)
    hist = rng.uniform(-2000, 2000, (2, 12, 32)).astype(np.float32)
    ref, ref_hist = jbl._filter_block(jnp.asarray(stacked), jnp.asarray(hist), jnp.int32(n_real))
    got, got_hist = tbl.filter_block(torch.from_numpy(stacked), torch.from_numpy(hist), n_real)
    ref = np.asarray(ref)
    assert got.dtype == torch.int16 and tuple(got.shape) == ref.shape == (3, 2 * NS)
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= BL_SLACK, ((diff == 0).mean(), diff.max())
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(ref_hist))


def test_polyphase_equals_direct_highrate_filter(blocks):
    """The port's polyphase path against the direct construction the JAX
    test pins (tests/test_bandlimit.py): interleave the port's 12 phase
    streams into the 31.2 Msps waveform, filter with the 385 taps,
    decimate by 12; the emitted stream is that, delayed by V0 samples,
    to int16 truncation, across block edges."""
    state, cache, outs, his = tbl.initial_state(CPU), {}, [], []
    for batch in blocks:
        n = batch.f_code.shape[0]
        x = tbl.synth_phases(batch, NS, pad_epochs=4, code_cache=cache, device=CPU).numpy()
        out, state = tbl.filter_block(torch.from_numpy(x), state, n)
        outs.append(out.numpy()[:n].reshape(-1))
        for b in range(n):
            hi = np.empty(12 * NS, np.complex128)
            for j in range(12):
                hi[j::12] = x[j, b, 0::2] + 1j * x[j, b, 1::2]
            his.append(hi)
    direct = np.convolve(np.concatenate(his), tbl.lowpass_taps(), mode="same")[::12]
    got = np.concatenate(outs)
    got_cx = got[0::2].astype(np.float64) + 1j * got[1::2]
    a, b = got_cx[tbl.V0:], direct[: got_cx.size - tbl.V0]
    err_i = np.abs(a.real - np.trunc(b.real))
    err_q = np.abs(a.imag - np.trunc(b.imag))
    assert np.percentile(err_i, 99.9) <= 1.0
    assert err_i.max() <= 2 and err_q.max() <= 2, (err_i.max(), err_q.max())


@pytest.mark.parametrize("apply_gain", [False, True])
def test_blocks_match_jax(blocks, apply_gain):
    """Three streamed blocks (the last a partial one) with the overlap
    state carried, port against JAX: phase stacks to `cboc_bar`, outputs
    to the per-sample bound."""
    t_state, j_state, cache = tbl.initial_state(CPU), jbl.initial_state(), {}
    ys_t, ys_j, xs_t, xs_j = [], [], [], []
    for batch in blocks:
        n = batch.f_code.shape[0]
        x_t = tbl.synth_phases(batch, NS, 4, cache, apply_gain, device=CPU)
        x_j = jax_phases(batch, apply_gain)
        bar = cboc_bar(x_t.numpy()[:, :n], x_j[:, :n])
        assert bar["ok"], bar
        y_t, t_state = tbl.synth_block_cboc_bandlimited(
            batch, NS, pad_epochs=4, code_cache=cache, state=t_state,
            apply_gain=apply_gain, device=CPU,
        )
        y_j, j_state = jbl.synth_block_cboc_bandlimited(
            batch, NS, pad_epochs=4, engine="xla", state=j_state, apply_gain=apply_gain,
        )
        ys_t.append(y_t.numpy()[:n].reshape(-1))
        ys_j.append(np.asarray(y_j)[:n].reshape(-1))
        xs_t.append(x_t.numpy()[:, :n].reshape(12, -1))
        xs_j.append(x_j[:, :n].reshape(12, -1))
    bar = bandlimit_bar(np.concatenate(ys_t), np.concatenate(ys_j),
                        np.concatenate(xs_t, axis=1), np.concatenate(xs_j, axis=1))
    assert bar["ok"], bar


def test_block_is_twelve_int16_calls(blocks, monkeypatch):
    """Each block is one call of the kernel's int16 wrapper on its 12
    phase-shifted copies stacked on the epoch axis (12 x 4 epochs, n_k
    unchanged): 12 distinct phase rows of cp0, phase j's epochs at rows
    4j..4j+3, and one code table."""
    calls = []

    def spy(inputs, n_k):
        calls.append((inputs["cp0"].clone(), n_k))
        return synth_kp_cuda.synth_kp_int16(inputs, n_k)

    monkeypatch.setattr(tbl, "synth_kp_int16", spy)
    cache = {}
    out, state = tbl.synth_block_cboc_bandlimited(blocks[0], NS, pad_epochs=4, code_cache=cache, device=CPU)
    assert len(calls) == 1 and calls[0][1] == 8
    cp0 = calls[0][0].numpy()
    assert cp0.shape == (12 * 4, 8)
    assert len({row.tobytes() for row in cp0.reshape(12, -1)}) == 12  # 12 distinct phases
    for j in (0, 5, 11):
        leg = tkp.compact_channels(tbl.phase_shift_batch(blocks[0], j))
        np.testing.assert_array_equal(cp0[4 * j:4 * j + 4], leg.code_phase0.astype(np.float32))
    assert tuple(out.shape) == (4, 2 * NS) and tuple(state.shape) == (2, 12, 32)
    assert set(cache) == {"key", "vpack_rs"}


@pytest.mark.parametrize("apply_gain", [False, True], ids=["no_gain", "gain"])
@pytest.mark.parametrize("block, n_real", [(1, 1), (4, 4), (4, 2)],
                         ids=["b1", "b4_full", "b4_partial"])
def test_phase_stack_equals_twelve_calls(blocks, block, n_real, apply_gain, monkeypatch):
    """`synth_phases` (one prep and one call of 12 x block epochs) equals
    the 12 calls of `block` epochs bit for bit, on full and partial
    blocks, and its (12, block, 2N) result is a view of the one call's
    output."""
    batch = first_epochs(blocks[1], n_real)
    outs = []

    def spy(inputs, n_k):
        outs.append(synth_kp_cuda.synth_kp_int16(inputs, n_k))
        return outs[-1]

    monkeypatch.setattr(tbl, "synth_kp_int16", spy)
    got = tbl.synth_phases(batch, NS, pad_epochs=block, code_cache={}, apply_gain=apply_gain,
                           device=CPU)
    assert len(outs) == 1 and tuple(outs[0].shape) == (12 * block, 2 * NS)
    assert tuple(got.shape) == (12, block, 2 * NS) and got.dtype == torch.int16
    assert got.data_ptr() == outs[0].data_ptr()
    assert got._base is not None and got._base is outs[0]._base  # a view, no copy
    ref = twelve_calls(batch, block, {}, apply_gain)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_sine_boc_batch_is_refused():
    batch = next(fixture_engine(0.3).batches(2))
    with pytest.raises(ValueError, match="CBOC"):
        tbl.synth_phases(batch, NS, device=CPU)
