"""The 90th percentile of all control steps' ms in the window: the gap
between CUDA events recorded at consecutive step ends, with no
synchronize inside the window."""

import harness

UNIT = 'ms'


def read(ctx):
    return harness.percentile(ctx['unit_ms'], 90)
