"""Soft-indicator reward shaping (port of mujoco_mbrl_tpu/suite/rewards.py).

``tolerance(x)`` is 1 inside [lower, upper] and decays through a sigmoid
outside, reaching ``value_at_margin`` at distance ``margin``. Bounds and
margins are static Python numbers; ``x`` is a tensor of any shape.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoids(x, value_at_1: float, sigmoid: str):
    if sigmoid in ('cosine', 'linear', 'quadratic'):
        if not 0 <= value_at_1 < 1:
            raise ValueError('`value_at_1` must be nonnegative and smaller '
                             'than 1, got {}.'.format(value_at_1))
    elif not 0 < value_at_1 < 1:
        raise ValueError('`value_at_1` must be strictly between 0 and 1, '
                         'got {}.'.format(value_at_1))
    if sigmoid == 'gaussian':
        scale = np.sqrt(-2 * np.log(value_at_1))
        return torch.exp(-0.5 * (x * scale) ** 2)
    if sigmoid == 'hyperbolic':
        return 1 / torch.cosh(x * np.arccosh(1 / value_at_1))
    if sigmoid == 'long_tail':
        return 1 / ((x * np.sqrt(1 / value_at_1 - 1)) ** 2 + 1)
    if sigmoid == 'cosine':
        scaled = x * (np.arccos(2 * value_at_1 - 1) / np.pi)
        return torch.where(scaled.abs() < 1,
                           (1 + torch.cos(np.pi * scaled)) / 2, 0.0)
    if sigmoid == 'linear':
        scaled = x * (1 - value_at_1)
        return torch.where(scaled.abs() < 1, 1 - scaled.abs(), 0.0)
    if sigmoid == 'quadratic':
        scaled = x * np.sqrt(1 - value_at_1)
        return torch.where(scaled.abs() < 1, 1 - scaled ** 2, 0.0)
    if sigmoid == 'tanh_squared':
        return 1 - torch.tanh(x * np.arctanh(np.sqrt(1 - value_at_1))) ** 2
    raise ValueError('Unknown sigmoid type {!r}.'.format(sigmoid))


def tolerance(x, bounds=(0.0, 0.0), margin=0.0, sigmoid='gaussian',
              value_at_margin=_DEFAULT_VALUE_AT_MARGIN):
    """1 when x is within bounds, decaying to 0 outside."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError('Lower bound must be <= upper bound.')
    if margin < 0:
        raise ValueError('`margin` must be non-negative.')
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return torch.where(in_bounds, 1.0, 0.0).to(x.dtype)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, 1.0, _sigmoids(d, value_at_margin, sigmoid))
