"""Goal-state planning costs (port of mujoco_mbrl_tpu/models/costs.py)."""

from __future__ import annotations

import torch


def smooth_abs_loss(x, goal_state, weights, alpha: float = 0.4):
    """sum(sqrt((w*(x-g))^2 + a^2) - a) over the last axis."""
    d = (x - goal_state) * weights
    return torch.sum(torch.sqrt(d * d + alpha * alpha) - alpha, dim=-1)


def cosh_loss(u, alpha: float = 0.25):
    """alpha^2 * mean(cosh(u/alpha) - 1) over the last axis."""
    return (alpha ** 2) * torch.mean(torch.cosh(u / alpha) - 1, dim=-1)


class CoshLoss:
    """Action cost module (costs.py:75-80); agents read its ``alpha``."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha

    def __call__(self, u):
        return cosh_loss(u, self.alpha)
