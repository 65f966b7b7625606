"""The CUDA kernel and the port's GPU path, on the card only.

These tests import no JAX (the GPU machine has none), so they run there
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held to its plain PyTorch version on the same operands, on
the card, to the engine bar (>= 99.9% of int16 values identical, every
difference within 4 * LUT_AMPLITUDE = 1000); the direct engine on the
card must equal its CPU run exactly under lut512.  Without a GPU every
test skips: a CUDA kernel has no CPU mode.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from galileo_sdr_sim_tpu.io.sinks import Sink
from galileo_sdr_sim_tpu_torch.harness import CASES, engine_bar, fixture_engine, synthetic_kp_inputs
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.ops import synth as tsynth
from galileo_sdr_sim_tpu_torch.ops import synth_kp as tkp
from galileo_sdr_sim_tpu_torch.ops import synth_kp_cuda

NAV = Path(__file__).resolve().parent / "data" / "obs_fixture_nav.rnx"
CPU = torch.device("cpu")
N_K = 200  # full 0.1 s epochs

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


class _Collect(Sink):
    def __init__(self):
        self.blocks = []

    def write(self, iq16: np.ndarray) -> None:
        self.blocks.append(np.array(iq16, copy=True))

    def stream(self) -> np.ndarray:
        return np.concatenate([b.reshape(-1) for b in self.blocks])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", [8, 16])
def test_kernel_matches_plain_version(gpu, C, case):
    inputs = synthetic_kp_inputs(8, C, 7, case, gpu)
    before = synth_kp_cuda.launch_count
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K)
    assert synth_kp_cuda.launch_count == before + 1
    ref = tkp.synth_kp_packed_ref(inputs, N_K)
    torch.cuda.synchronize()
    assert got.device == gpu and got.dtype == torch.int32
    assert tuple(got.shape) == (8, N_K, 1300)
    bar = engine_bar(got.cpu().numpy(), ref.cpu().numpy())
    assert bar["ok"], bar


def test_kernel_matches_plain_version_on_fixture_block(gpu):
    batch = next(fixture_engine(NAV, 1.0).batches(8))
    inputs = tkp.prepare_kp_inputs(batch, N_K * 1300, pad_epochs=8, device=gpu)
    got = synth_kp_cuda.synth_kp_packed(inputs, N_K).cpu().numpy()
    ref = tkp.synth_kp_packed_ref(inputs, N_K).cpu().numpy()
    bar = engine_bar(got, ref)
    assert bar["ok"], bar
    assert np.count_nonzero(got) > 0.9 * got.size


def test_wrapper_refuses_operands_off_the_card(gpu):
    inputs = synthetic_kp_inputs(8, 8, 7, "random", gpu)
    inputs["vpack_rs"] = inputs["vpack_rs"].cpu()
    before = synth_kp_cuda.launch_count
    with pytest.raises(ValueError, match="vpack_rs"):
        synth_kp_cuda.synth_kp_packed(inputs, N_K)
    assert synth_kp_cuda.launch_count == before


def test_stream_on_the_card_goes_through_the_kernel(gpu):
    before = synth_kp_cuda.launch_count
    sink = _Collect()
    stats = StreamingSynthesizer(fixture_engine(NAV, 1.6), sink, device=gpu).run()
    assert synth_kp_cuda.launch_count - before == 2  # 15 epochs, B = 8
    assert stats.epochs == 15
    cpu_sink = _Collect()
    StreamingSynthesizer(fixture_engine(NAV, 1.6), cpu_sink, device=CPU).run()
    got, ref = sink.stream(), cpu_sink.stream()
    assert got.size == 15 * 2 * 260000
    bar = engine_bar(got, ref)
    assert bar["ok"], bar


@pytest.mark.parametrize("mode", ["lut512", "float"])
def test_direct_engine_on_the_card(gpu, mode):
    batch = next(fixture_engine(NAV, 1.0).batches(2))
    tile, ns = 2048, 26000
    dev = tsynth.prepare_device_inputs(batch, tile, ns, device=gpu)
    host = tsynth.prepare_device_inputs(batch, tile, ns, device=CPU)
    got = tsynth.synth_block(dev, tile=tile, mode=mode).cpu().numpy()
    ref = tsynth.synth_block(host, tile=tile, mode=mode).numpy()
    if mode == "lut512":
        np.testing.assert_array_equal(got, ref)
    else:
        bar = engine_bar(got, ref)
        assert bar["ok"], bar
