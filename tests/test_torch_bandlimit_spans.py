"""The band-limited path's spans (profiling.span) on the CPU: in the stream
the 12 phases' one host prep and one kernel call are one
`host_prep+dispatch/seed`, `/h2d` and `/launch` entry a block, as the
pointwise models' are, and the polyphase filter one
`host_prep+dispatch/filter` entry a block (none pointwise); in every
model the code table reads are one `scenario/pack/codes` entry a block.  With no
Timer installed the spans do nothing: the `--bandlimit` command line's
file, made under the stream's Timer, is the same byte for byte as the
blocks made with no Timer installed."""

import numpy as np
import pytest

from galileo_sdr_sim_tpu_torch import cli, profiling, scenario
from galileo_sdr_sim_tpu_torch.io.stream import StreamingSynthesizer
from galileo_sdr_sim_tpu_torch.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu_torch.models.e1 import E1_OS
from galileo_sdr_sim_tpu_torch.ops.bandlimit import synth_block_cboc_bandlimited
from galileo_sdr_sim_tpu_torch.rinex import read_rinex_v3

from _torch_parity import CPU, LLH, NAV, START
from conftest import CollectSink

BLOCK = 8
BLOCKS = 2  # 1.7 s: 16 epochs


def live_engine(duration_s: float, model) -> scenario.ScenarioEngine:
    """The fixture scene from a live position source at the fixture site,
    as the benchmark's jobs run it."""
    nav = read_rinex_v3(str(NAV))
    llh = np.array(LLH, np.float64)
    g0 = scenario.scenario_start_time(nav, cli._parse_time(START))
    return scenario.ScenarioEngine(nav, scenario.PositionProvider(live=lambda: llh), g0,
                                   duration_s, model=model)


@pytest.mark.parametrize("model, bandlimit", [(E1_OS, False), (E1_CBOC, False), (E1_CBOC, True)],
                         ids=["e1", "cboc", "cboc_bandlimit"])
def test_span_entries_a_block(model, bandlimit):
    synth = StreamingSynthesizer(live_engine(1.7, model), CollectSink(), device=CPU,
                                 block_epochs=BLOCK, nsamples=10400, bandlimit=bandlimit)
    timer = synth.run().timer
    counts, sections = timer.counts, timer.sections
    assert counts["scenario/pack"] == counts["scenario/pack/codes"] \
        == counts["host_prep+dispatch"] == BLOCKS
    assert counts["host_prep+dispatch/launch"] == counts["host_prep+dispatch/seed"] \
        == counts["host_prep+dispatch/h2d"] == BLOCKS  # one prep and kp call a block
    assert counts.get("host_prep+dispatch/filter", 0) == (BLOCKS if bandlimit else 0)
    assert sections["scenario/pack/codes"] <= sections["scenario/pack"]
    prep = sections["host_prep+dispatch"]
    assert sections["host_prep+dispatch/launch"] \
        + sections.get("host_prep+dispatch/filter", 0.0) <= prep


def test_bandlimit_cli_file_is_the_same_without_a_timer(tmp_path):
    static = tmp_path / "static.csv"
    static.write_text(",".join(str(v) for v in LLH) + "\n")
    argv = ["-e", str(NAV), "-U", "1", "-b", "1", "-d", "0.4", "-t", START, "-u", str(static),
            "--device", "cpu", "--bandlimit", "--block-epochs", "2",
            "-o", str(tmp_path / "cli.ishort")]
    assert cli.main(argv) == 0
    engine, servers = cli.build_engine(cli.build_torch_parser().parse_args(argv))
    assert servers is None and engine.model is E1_CBOC
    assert profiling._THREAD.stack is None  # no Timer installed
    state, cache, blocks = None, {}, []
    for batch in engine.batches(2):
        out, state = synth_block_cboc_bandlimited(batch, pad_epochs=2, code_cache=cache,
                                                  state=state, device=CPU)
        blocks.append(out[: batch.f_code.shape[0]].numpy())
    assert [b.shape[0] for b in blocks] == [2, 1]  # the filter's history crosses a block edge
    got = (tmp_path / "cli.ishort").read_bytes()
    assert len(got) == 3 * 260000 * 4
    assert got == np.concatenate(blocks).tobytes()
