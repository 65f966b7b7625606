"""sink_share_pct: the stream's Timer section `sink_write`, the sink (the
tee and the program's `FileSink` on os.devnull), summed over the
window's jobs up to the close, as a share of the window."""

SECTION = "sink_write"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
