"""Shares of the traced window shared by the ``mfu_pct.*`` and
``device_idle_pct.*`` readers."""

from counts import peaks


def mfu(ctx):
    """The model FLOP of the traced units over the traced window's
    seconds, as a share of the peak of the configuration's precision."""
    trace = ctx['trace']
    if trace is None or trace.window_s <= 0:
        return None
    flops = ctx['cell'].model_flops * trace.units
    peak = peaks.PEAK_FLOPS[ctx['cfg']['precision']]
    return 100.0 * flops / trace.window_s / peak


def idle(ctx):
    """100 - the union of the device ops' intervals over the traced
    window."""
    trace = ctx['trace']
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
