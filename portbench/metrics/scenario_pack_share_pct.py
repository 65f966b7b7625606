"""scenario_pack_share_pct: the stream's Timer section `scenario/pack`,
`ScenarioEngine._pack`, the block's code tables copied into the batch,
summed over the window's jobs up to the close, as a share of the window.
Its parent section includes it."""

SECTION = "scenario/pack"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
