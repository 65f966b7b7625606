"""scenario_pack_codes_share_pct: the stream's Timer section
`scenario/pack/codes`, `ScenarioEngine._pack`'s three reads of the
model's code tables and the rows copied from them (under CBOC each read
rebuilds a (50, 49104) float32 table), summed over the window's jobs up
to the close, as a share of the window.  Its parent section
`scenario/pack` includes it."""

SECTION = "scenario/pack/codes"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
