"""host_prep_share_pct: the stream's Timer section `host_prep+dispatch`,
host prep and dispatch (`prepare_kp_inputs`, the band-limit preps, the
launches), summed over the window's jobs up to the close, as a share of
the window."""

SECTION = "host_prep+dispatch"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
