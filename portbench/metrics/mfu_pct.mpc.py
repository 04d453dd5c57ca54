"""The whole control step's share of the chip's peak: the model's FLOP
(the sampler's MLP rollouts; physics FLOP are not the model's and are
left out) over the traced units' seconds, against the TF32 peak."""

import harness

UNIT = '%'
_shares = harness.load_module('metrics', '_shares')


def read(ctx):
    return _shares.mfu(ctx)
