"""scenario_nav_share_pct: the stream's Timer section `scenario/nav_page`,
the I/NAV pages built (`regenerate_page`: words, CRC-24Q, FEC-2 RS,
convolutional code, interleaving), summed over the window's jobs up to
the close, as a share of the window. Its parent section includes it."""

SECTION = "scenario/nav_page"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
