"""drain_share_pct: the stream's Timer section `device_wait+fetch`, the
drain (the wait on the pinned copy's event), summed over the window's
jobs up to the close, as a share of the window."""

SECTION = "device_wait+fetch"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
