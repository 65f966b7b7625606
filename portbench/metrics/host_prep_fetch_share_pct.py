"""host_prep_fetch_share_pct: the stream's Timer section
`host_prep+dispatch/fetch`, `_Fetch.__init__`: the pinned output buffer,
the D2H copy's enqueue and its event, summed over the window's jobs up
to the close, as a share of the window. Its parent section includes it."""

SECTION = "host_prep+dispatch/fetch"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
