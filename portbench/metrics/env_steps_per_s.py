"""Env-steps completed a second: B x control steps over the window's
wall time, which ends with a synchronize (host clock)."""

UNIT = 'env-steps/s'


def read(ctx):
    return ctx['cell'].units_per_step * ctx['units'] / ctx['window_s']
