"""scenario_geometry_share_pct: the stream's Timer section
`scenario/geometry`, receiver geometry in `ScenarioEngine._step_block`,
the scenario's one stepping path (the receiver position to ECEF, the
stacked ephemerides, `compute_range`, `code_phase_state`, the vectorized
gains), summed over the window's jobs up to the close, as a share of the
window. Its parent section includes it."""

SECTION = "scenario/geometry"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
