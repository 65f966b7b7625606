"""samples_per_s: complex samples handed to the sink while the window was
open, over the window's seconds (host clock, tracing off)."""


def read(obs):
    return obs.samples / obs.window_s
