"""MLP dynamics model and normalizers.

Port of the MLP part of mujoco_mbrl_tpu/models/dynamics.py.

Parameters are the JAX package's tree as a plain dict of tensors,
``{'l1', 'l2', 'l3'} x {'w', 'b'}`` with ``w`` stored (in, out), so
converted weights line up one to one (see ``convert.mlp_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Normalizers:
    """Forward-time normalization bundle (None members = identity)."""
    state_mean: Optional[torch.Tensor] = None
    state_std: Optional[torch.Tensor] = None
    action_mean: Optional[torch.Tensor] = None
    action_std: Optional[torch.Tensor] = None
    reward_mean: Optional[torch.Tensor] = None
    reward_std: Optional[torch.Tensor] = None

    def norm_state(self, s):
        if self.state_mean is None:
            return s
        return (s - self.state_mean) / (self.state_std + 1e-6)

    def unnorm_state(self, s):
        if self.state_mean is None:
            return s
        return s * (self.state_std + 1e-6) + self.state_mean

    def norm_action(self, a):
        if self.action_mean is None:
            return a
        return (a - self.action_mean) / (self.action_std + 1e-6)


def _dense_init(generator, n_in, n_out, dtype, device):
    """LeCun-uniform fan-in init (torch nn.Linear default semantics)."""
    bound = 1.0 / n_in ** 0.5
    u = lambda *shape: (torch.rand(shape, generator=generator, dtype=dtype)
                        * 2 - 1) * bound
    return {'w': u(n_in, n_out).to(device), 'b': u(n_out).to(device)}


def _dense(params, x):
    return x @ params['w'] + params['b']


class MLPDynamics:
    """s' = MLP([s; a]) with two ReLU hidden layers (models.py:96-110)."""

    def __init__(self, state_dim: int, action_dim: int,
                 hidden_units: int = 50, dtype=torch.float32):
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_units = hidden_units
        self.dtype = dtype

    def init(self, generator: torch.Generator, device='cpu'
             ) -> Dict[str, Any]:
        h = self.hidden_units
        return {
            'l1': _dense_init(generator, self.state_dim + self.action_dim, h,
                              self.dtype, device),
            'l2': _dense_init(generator, h, h, self.dtype, device),
            'l3': _dense_init(generator, h, self.state_dim, self.dtype,
                              device),
        }

    def forward(self, params, state, action,
                normalizers: Optional[Normalizers] = None):
        n = normalizers or Normalizers()
        x = torch.cat([n.norm_state(state), n.norm_action(action)], dim=-1)
        x = torch.relu(_dense(params['l1'], x))
        x = torch.relu(_dense(params['l2'], x))
        return n.unnorm_state(_dense(params['l3'], x))
