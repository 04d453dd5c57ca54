"""Goal-state planning costs (port of mujoco_mbrl_tpu/models/costs.py):
smooth-abs state cost, cosh action cost, quadratic cost and a learned cost
MLP, as functions and as the classes with a ``set_goal_state`` protocol."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from .dynamics import _dense, _dense_init


def smooth_abs_loss(x, goal_state, weights, alpha: float = 0.4):
    """sum(sqrt((w*(x-g))^2 + a^2) - a) over the last axis."""
    d = (x - goal_state) * weights
    return torch.sum(torch.sqrt(d * d + alpha * alpha) - alpha, dim=-1)


def cosh_loss(u, alpha: float = 0.25):
    """alpha^2 * mean(cosh(u/alpha) - 1) over the last axis."""
    return (alpha ** 2) * torch.mean(torch.cosh(u / alpha) - 1, dim=-1)


def quadratic_cost(x, goal_state, Q):
    """(x - g)^T Q (x - g) over the last axis."""
    d = x - goal_state
    return torch.einsum('...i,ij,...j->...', d, Q, d)


def state_action_cost(state, action, state_cost, action_cost):
    """Total planning cost of a state and an action."""
    return state_cost(state) + action_cost(action)


class StateCost:
    """Base of the goal-conditioned state costs."""
    goal_state: Optional[torch.Tensor] = None

    def set_goal_state(self, goal_state):
        self.goal_state = goal_state


class SmoothAbsLoss(StateCost):
    def __init__(self, weights, goal_state=None, alpha: float = 0.4):
        self.weights = weights
        self.goal_state = goal_state
        self.alpha = alpha

    def __call__(self, x):
        return smooth_abs_loss(x, self.goal_state, self.weights, self.alpha)


class CoshLoss:
    """Action cost module (costs.py:75-80); agents read its ``alpha``."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha

    def __call__(self, u):
        return cosh_loss(u, self.alpha)


class QuadraticCost(StateCost):
    """Q drawn uniform in [0, 1/dim) from ``generator`` (the JAX class
    draws it from a key, PRNGKey(0) by default)."""

    def __init__(self, dim: int, goal_state=None,
                 generator: Optional[torch.Generator] = None):
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.Q = torch.rand((dim, dim), generator=generator,
                            device=generator.device) / dim
        self.goal_state = goal_state

    def __call__(self, x):
        return quadratic_cost(x, self.goal_state, self.Q)


class CostModel:
    """Learned cost MLP c(s, a) with two ReLU hidden layers."""

    def __init__(self, state_dim: int, action_dim: int,
                 hidden_units: int = 70, dtype=torch.float32):
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_units = hidden_units
        self.dtype = dtype

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, Any]:
        device = resolve_device(device)
        h = self.hidden_units
        return {
            'l1': _dense_init(generator, self.state_dim + self.action_dim, h,
                              self.dtype, device),
            'l2': _dense_init(generator, h, h, self.dtype, device),
            'l3': _dense_init(generator, h, 1, self.dtype, device),
        }

    def forward(self, params, state, action):
        x = torch.cat([state, action], dim=-1)
        x = torch.relu(_dense(params['l1'], x))
        x = torch.relu(_dense(params['l2'], x))
        return _dense(params['l3'], x)
