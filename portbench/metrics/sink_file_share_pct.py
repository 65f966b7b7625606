"""sink_file_share_pct: the stream's Timer section `sink_write/file`, the
program's `FileSink.write` (`ascontiguousarray`, `tobytes`, the write to
os.devnull), without the tee, summed over the window's jobs up to the
close, as a share of the window. Its parent section includes it."""

SECTION = "sink_write/file"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
