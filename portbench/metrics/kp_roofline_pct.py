"""kp_roofline_pct: the kp pair's least time (portbench/harness/roofline.py,
counted from each call's B and C) over its device time (the profiler's
events of the prologue and the main kernel), summed over the window's
calls, in %.  Against the peaks of a 700 W H100; the card's power limit
is printed beside it."""

from portbench.harness.roofline import kp_least_s


def read(obs):
    calls = obs.trace.kp_calls if obs.trace is not None else []
    busy = sum(c.seconds for c in calls)
    if not busy:
        return None
    return 100.0 * sum(kp_least_s(c.B, c.C, c.cboc, c.gain) for c in calls) / busy
