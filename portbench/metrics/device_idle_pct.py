"""device_idle_pct: 100 less the union of the device's kernel, copy and
memset intervals over the traced window, in %."""


def read(obs):
    t = obs.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
