"""bl_filter_roofline_pct: the band-limit filter's least time
(portbench/harness/roofline.py, one call a block of `block_epochs`) over
the device time of the kernels launched from its aten::conv1d calls,
summed over the window, in %."""

from portbench.harness.roofline import filter_least_s


def read(obs):
    t = obs.trace
    if t is None or not t.conv_calls or not t.conv_seconds:
        return None
    return 100.0 * t.conv_calls * filter_least_s(obs.cell.traffic["block_epochs"]) / t.conv_seconds
