"""host_prep_seed_share_pct: the stream's Timer section
`host_prep+dispatch/seed`, `prepare_kp_inputs`' compaction, padding,
float64 seeding and `kernel_operands`, summed over the window's jobs up
to the close, as a share of the window. Its parent section includes it."""

SECTION = "host_prep+dispatch/seed"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
