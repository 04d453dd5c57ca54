"""The device's idle share of the traced window: 100 - the union of the
device ops' intervals over the window."""

import harness

UNIT = '%'
_shares = harness.load_module('metrics', '_shares')


def read(ctx):
    return _shares.idle(ctx)
