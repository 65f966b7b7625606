"""host_prep_launch_share_pct: the stream's Timer section
`host_prep+dispatch/launch`, `synth_kp_packed` called from the stream
(the wrapper and the kp pair's launch), summed over the window's jobs up
to the close, as a share of the window. Its parent section includes it."""

SECTION = "host_prep+dispatch/launch"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
