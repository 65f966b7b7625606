"""scenario_share_pct: the stream's Timer section `scenario`, scenario
stepping (`ScenarioEngine.batches`), summed over the window's jobs up to
the close, as a share of the window."""

SECTION = "scenario"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
