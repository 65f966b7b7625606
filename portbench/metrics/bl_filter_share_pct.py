"""bl_filter_share_pct: the stream's Timer section
`host_prep+dispatch/filter`, `ops/bandlimit.filter_block` called from the
band-limited stream (cast, de-interleave, the history's `cat`, the 12x33
weights' pageable copy, conv1d, trunc, re-interleave; one entry a block),
summed over the window's jobs up to the close, as a share of the window.
Its parent section includes it.  On a GPU the weights' pageable copy
waits for the block's 12 kp pairs on the stream, so the section holds
their device time too: a faster kp pair moves it with no change to the
filter."""

SECTION = "host_prep+dispatch/filter"


def read(obs):
    if SECTION not in obs.sections:
        return None
    return 100.0 * obs.sections[SECTION] / obs.window_s
