"""MLP and ensemble dynamics models and normalizers.

Port of the MLPDynamics, EnsembleDynamics and Normalizers parts of
mujoco_mbrl_tpu/models/dynamics.py.

Parameters are the JAX package's tree as a plain dict of tensors,
``{'l1', 'l2', 'l3'} x {'w', 'b'}`` with ``w`` stored (in, out), so
converted weights line up one to one (see ``convert.mlp_params``); an
ensemble's leaves carry a leading member axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device


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

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, Any]:
        """Weights drawn on the CPU from ``generator``, placed on ``device``
        (default ``cuda``)."""
        device = resolve_device(device)
        h = self.hidden_units
        return {
            'l1': _dense_init(generator, self.state_dim + self.action_dim, h,
                              self.dtype, device),
            'l2': _dense_init(generator, h, h, self.dtype, device),
            'l3': _dense_init(generator, h, self.state_dim, self.dtype,
                              device),
        }

    def _net(self, params, x):
        x = torch.relu(_dense(params['l1'], x))
        x = torch.relu(_dense(params['l2'], x))
        return _dense(params['l3'], x)

    def forward(self, params, state, action,
                normalizers: Optional[Normalizers] = None):
        n = normalizers or Normalizers()
        x = torch.cat([n.norm_state(state), n.norm_action(action)], dim=-1)
        return n.unnorm_state(self._net(params, x))

    def loss(self, params, batch, normalizers: Optional[Normalizers] = None,
             generator: Optional[torch.Generator] = None):
        """Teacher-forced MSE in normalized space (dynamics.py:120-134):
        batch fields (B, h, dim); mean over batch and dim, summed over h.
        ``generator`` is ignored (the ensemble's bootstrap draws from it)."""
        n = normalizers or Normalizers()
        x = torch.cat([n.norm_state(batch['states']),
                       n.norm_action(batch['actions'])], dim=-1)
        pred = self._net(params, x)
        target = n.norm_state(batch['next_states'])
        per_step = torch.mean((pred - target) ** 2,
                              dim=(0,) + tuple(range(2, pred.ndim)))
        return per_step.sum()


def _stacked_net(params, x):
    """Every member's MLP on its own rows: x (n, N, in) -> (n, N, sd), one
    batched product per layer over the stacked (n, in, out) weights."""
    bmm = lambda p, h: torch.baddbmm(p['b'][:, None], h, p['w'])
    x = torch.relu(bmm(params['l1'], x))
    x = torch.relu(bmm(params['l2'], x))
    return bmm(params['l3'], x)


class EnsembleDynamics:
    """n-member ensemble of MLPDynamics (dynamics.py:316-391).

    Parameters are the base model's tree with a leading member axis.
    ``forward`` is the members' mean; ``forward_ts`` does TS-infinity
    propagation (row k -> member k % n); ``loss`` sums the members' losses,
    each on its own bootstrap resample of the batch when a generator is
    given.
    """

    def __init__(self, base: MLPDynamics, n_ensemble: int = 5):
        if type(base) is not MLPDynamics:
            raise NotImplementedError(
                'only an MLPDynamics base is ported '
                '(mujoco_mbrl_tpu.models.dynamics.EnsembleDynamics)')
        self.base = base
        self.n = n_ensemble
        self.state_dim = base.state_dim
        self.action_dim = base.action_dim

    def init(self, generator: torch.Generator, device=None):
        device = resolve_device(device)
        members = [self.base.init(generator, device) for _ in range(self.n)]
        return {layer: {k: torch.stack([m[layer][k] for m in members])
                        for k in ('w', 'b')} for layer in members[0]}

    def _inputs(self, state, action, normalizers):
        n = normalizers or Normalizers()
        return n, torch.cat([n.norm_state(state), n.norm_action(action)],
                            dim=-1)

    def forward_all(self, params, state, action,
                    normalizers: Optional[Normalizers] = None):
        """Every member on every row: (..., dim) -> (n, ..., sd)."""
        n, x = self._inputs(state, action, normalizers)
        flat = x.reshape(-1, x.shape[-1]).expand(self.n, -1, -1)
        out = _stacked_net(params, flat)
        return n.unnorm_state(out.reshape((self.n,) + x.shape[:-1] + (-1,)))

    def forward(self, params, state, action,
                normalizers: Optional[Normalizers] = None):
        return self.forward_all(params, state, action, normalizers).mean(0)

    def forward_ts(self, params, state, action,
                   normalizers: Optional[Normalizers] = None):
        """TS-infinity: state/action (N, dim), row k -> member k % n; the
        ensemble mean when N is not divisible by n (as in JAX)."""
        N = state.shape[0]
        if N % self.n:
            return self.forward(params, state, action, normalizers)
        n, x = self._inputs(state, action, normalizers)
        xg = x.reshape(N // self.n, self.n, -1).transpose(0, 1)
        out = _stacked_net(params, xg)                  # (n, N / n, sd)
        return n.unnorm_state(out.transpose(0, 1).reshape(N, -1))

    def loss(self, params, batch, normalizers: Optional[Normalizers] = None,
             generator: Optional[torch.Generator] = None):
        """Sum of the members' MLPDynamics losses; with a generator each
        member sees its own bootstrap resample (rows drawn with
        replacement) of the batch."""
        nm = normalizers or Normalizers()
        B = batch['states'].shape[0]
        fields = ('states', 'actions', 'next_states')
        if generator is None:
            rows = {k: batch[k].expand((self.n,) + batch[k].shape)
                    for k in fields}
        else:
            idx = torch.randint(0, B, (self.n, B), generator=generator,
                                device=generator.device).to(
                                    batch['states'].device)
            rows = {k: batch[k][idx] for k in fields}
        x = torch.cat([nm.norm_state(rows['states']),
                       nm.norm_action(rows['actions'])], dim=-1)
        pred = _stacked_net(params, x.reshape(self.n, -1, x.shape[-1]))
        target = nm.norm_state(rows['next_states'])
        pred = pred.reshape(target.shape)               # (n, B, h, sd)
        per_step = torch.mean((pred - target) ** 2,
                              dim=(1,) + tuple(range(3, pred.ndim)))
        return per_step.sum()
