"""Dynamics model families and normalizers.

Port of mujoco_mbrl_tpu/models/dynamics.py: ``MLPDynamics`` (with its
optional output noise), ``LinearDynamics``, ``RewardDynamics`` (next
state and reward heads), ``RNNDynamics`` (a GRU cell with a state head)
and ``EnsembleDynamics`` over any base.

Parameters are the JAX package's trees as plain dicts of tensors, each
dense layer ``{'w', 'b'}`` with ``w`` stored (in, out), so converted
weights line up one to one (see ``convert``); an ensemble's leaves carry a
leading member axis. The models are functions of their parameter trees
(no ``nn.Module``), so ``torch.func`` can differentiate and map them.
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

    def unnorm_reward(self, r):
        if self.reward_mean is None:
            return r
        return r * (self.reward_std + 1e-6) + self.reward_mean


def _dense_init(generator, n_in, n_out, dtype, device):
    """LeCun-uniform fan-in init (torch nn.Linear default semantics)."""
    bound = 1.0 / n_in ** 0.5
    u = lambda *shape: (torch.rand(shape, generator=generator, dtype=dtype)
                        * 2 - 1) * bound
    return {'w': u(n_in, n_out).to(device), 'b': u(n_out).to(device)}


def _dense(params, x):
    return x @ params['w'] + params['b']


class MLPDynamics:
    """s' = MLP([s; a]) with two ReLU hidden layers and optional Gaussian
    output noise of std ``noise`` (dynamics.py:73-134)."""

    def __init__(self, state_dim: int, action_dim: int,
                 hidden_units: int = 50, noise: Optional[float] = None,
                 dtype=torch.float32):
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_units = hidden_units
        self.noise = noise
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
                normalizers: Optional[Normalizers] = None,
                generator: Optional[torch.Generator] = None):
        """The noise is added in normalized space, and only when a
        ``generator`` is passed (JAX adds it only with a key)."""
        n = normalizers or Normalizers()
        x = torch.cat([n.norm_state(state), n.norm_action(action)], dim=-1)
        out = self._net(params, x)
        if self.noise is not None and generator is not None:
            out = out + torch.randn(
                out.shape, generator=generator, dtype=out.dtype,
                device=generator.device).to(out.device) * self.noise
        return n.unnorm_state(out)

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


class LinearDynamics(MLPDynamics):
    """A single affine layer (dynamics.py:137-145)."""

    def init(self, generator: torch.Generator, device=None):
        device = resolve_device(device)
        return {'l1': _dense_init(generator,
                                  self.state_dim + self.action_dim,
                                  self.state_dim, self.dtype, device)}

    def _net(self, params, x):
        return _dense(params['l1'], x)


class RewardDynamics:
    """Joint next-state and reward model: a shared two-layer ReLU trunk
    with a state head and a scalar reward head (dynamics.py:148-199)."""

    def __init__(self, state_dim: int, action_dim: int,
                 hidden_units: int = 200, dtype=torch.float32):
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_units = hidden_units
        self.dtype = dtype

    def init(self, generator: torch.Generator, device=None):
        device = resolve_device(device)
        h, nin = self.hidden_units, self.state_dim + self.action_dim
        return {
            'l1': _dense_init(generator, nin, h, self.dtype, device),
            'l2': _dense_init(generator, h, h, self.dtype, device),
            'state_head': _dense_init(generator, h, self.state_dim,
                                      self.dtype, device),
            'reward_head': _dense_init(generator, h, 1, self.dtype, device),
        }

    def _heads(self, params, n, state, action):
        x = torch.cat([n.norm_state(state), n.norm_action(action)], dim=-1)
        x = torch.relu(_dense(params['l1'], x))
        x = torch.relu(_dense(params['l2'], x))
        return _dense(params['state_head'], x), _dense(params['reward_head'],
                                                       x)

    def forward(self, params, state, action,
                normalizers: Optional[Normalizers] = None,
                generator: Optional[torch.Generator] = None):
        """(next state (..., sd), reward (..., 1)), unnormalized;
        ``generator`` is ignored, as JAX ignores its key."""
        n = normalizers or Normalizers()
        s, r = self._heads(params, n, state, action)
        return n.unnorm_state(s), n.unnorm_reward(r)

    def loss(self, params, batch, normalizers: Optional[Normalizers] = None,
             generator: Optional[torch.Generator] = None):
        """(state MSE + reward MSE, {'state_loss', 'reward_loss'}) in
        normalized space, each a mean over batch and dim summed over the
        window; the reward target is normalized by the reward stats.
        ``generator`` is ignored, as for ``MLPDynamics.loss``."""
        n = normalizers or Normalizers()
        pred_s, pred_r = self._heads(params, n, batch['states'],
                                     batch['actions'])
        target_s = n.norm_state(batch['next_states'])
        target_r = batch['rewards']
        if n.reward_mean is not None:
            target_r = (target_r - n.reward_mean[0]) / (n.reward_std[0]
                                                        + 1e-6)
        s_loss = torch.mean((pred_s - target_s) ** 2, dim=(0,) + tuple(
            range(2, pred_s.ndim))).sum()
        r_loss = torch.mean((pred_r[..., 0] - target_r) ** 2, dim=0).sum()
        return s_loss + r_loss, {'state_loss': s_loss, 'reward_loss': r_loss}


class RNNDynamics:
    """GRU sequence dynamics: h' = GRU(h, [s; a]) and s' = s + f(h', [s;
    a]) in normalized space (dynamics.py:202-313). ``rollout`` runs the
    model open loop on its own predictions; ``loss`` is teacher-forced
    over (B, h, dim) windows with the hidden state carried across the
    window."""

    def __init__(self, state_dim: int, action_dim: int,
                 hidden_units: int = 64, dtype=torch.float32):
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_units = hidden_units
        self.noise = None
        self.dtype = dtype

    def init(self, generator: torch.Generator, device=None):
        device = resolve_device(device)
        nin, h = self.state_dim + self.action_dim, self.hidden_units
        return {
            'gru_rz': _dense_init(generator, nin + h, 2 * h, self.dtype,
                                  device),
            'gru_n': _dense_init(generator, nin + h, h, self.dtype, device),
            'head1': _dense_init(generator, h + nin, h, self.dtype, device),
            'head2': _dense_init(generator, h, self.state_dim, self.dtype,
                                 device),
        }

    def init_hidden(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (self.hidden_units,),
                           dtype=self.dtype, device=resolve_device(device))

    def _cell(self, params, h, x):
        rz = torch.sigmoid(_dense(params['gru_rz'], torch.cat([x, h], -1)))
        r, z = torch.chunk(rz, 2, dim=-1)
        n = torch.tanh(_dense(params['gru_n'], torch.cat([x, r * h], -1)))
        return (1.0 - z) * n + z * h

    def _step(self, params, n, state, action, hidden):
        """(normalized next state, next hidden)."""
        x = torch.cat([n.norm_state(state), n.norm_action(action)], dim=-1)
        h_new = self._cell(params, hidden, x)
        y = torch.relu(_dense(params['head1'], torch.cat([h_new, x], -1)))
        return n.norm_state(state) + _dense(params['head2'], y), h_new

    def forward(self, params, state, action, hidden,
                normalizers: Optional[Normalizers] = None):
        """One transition: (next_state, next_hidden)."""
        if not isinstance(hidden, torch.Tensor):
            # the JAX agents call forward(params, s, a, normalizers), which
            # binds the normalizers to `hidden`; jnp.concatenate then
            # raises a TypeError in the GRU cell
            raise TypeError(
                f'RNNDynamics.forward got a {type(hidden).__name__} as its '
                'hidden state: the JAX agents pass the normalizers there '
                '(mujoco_mbrl_tpu.agents.mpc._plan_model_fn), and the JAX '
                'GRU cell fails the same way (concatenate requires ndarray)')
        n = normalizers or Normalizers()
        s, h_new = self._step(params, n, state, action, hidden)
        return n.unnorm_state(s), h_new

    def rollout(self, params, state0, actions,
                normalizers: Optional[Normalizers] = None,
                hidden0: Optional[torch.Tensor] = None):
        """Open loop: actions (H, ..., ad) -> states (H, ..., sd)."""
        h = (self.init_hidden(state0.shape[:-1], state0.device)
             if hidden0 is None else hidden0)
        s, states = state0, []
        for a in actions:
            s, h = self.forward(params, s, a, h, normalizers)
            states.append(s)
        return torch.stack(states)

    def loss(self, params, batch, normalizers: Optional[Normalizers] = None,
             generator: Optional[torch.Generator] = None):
        """Teacher-forced MSE over (B, h, dim) windows (or (B, dim)
        transitions): mean over batch and dim, summed over the window.
        ``generator`` is ignored."""
        n = normalizers or Normalizers()
        s, a = batch['states'], batch['actions']
        target = n.norm_state(batch['next_states'])
        if s.ndim == 2:
            s, a, target = s[:, None], a[:, None], target[:, None]
        h = self.init_hidden((s.shape[0],), s.device)
        preds = []
        for t in range(s.shape[1]):
            pred, h = self._step(params, n, s[:, t], a[:, t], h)
            preds.append(pred)
        preds = torch.stack(preds, 1)
        return torch.mean((preds - target) ** 2, dim=(0, 2)).sum()


def _stacked_net(params, x):
    """Every member's MLP on its own rows: x (n, N, in) -> (n, N, sd), one
    batched product per layer over the stacked (n, in, out) weights."""
    bmm = lambda p, h: torch.baddbmm(p['b'][:, None], h, p['w'])
    x = torch.relu(bmm(params['l1'], x))
    x = torch.relu(bmm(params['l2'], x))
    return bmm(params['l3'], x)


def _member(params, i: int):
    """Member i's tree of a tree with a leading member axis."""
    if isinstance(params, dict):
        return {k: _member(v, i) for k, v in params.items()}
    return params[i]


def _stack(trees):
    """Trees of equal structure -> one tree with a leading member axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class EnsembleDynamics:
    """n-member ensemble of a base dynamics family (dynamics.py:316-391).

    Parameters are the base model's tree with a leading member axis, as
    JAX's vmap over the members stacks them. ``forward`` is the members'
    mean; ``forward_ts`` does TS-infinity propagation (row k -> member k %
    n); ``loss`` sums the members' losses, each on its own bootstrap
    resample of the batch when a generator is given. A plain
    ``MLPDynamics`` base runs its members as one batched product a layer;
    any other base calls its own ``init``, ``forward`` and ``loss`` a
    member at a time, so a base JAX's vmap fails on fails here too (a
    ``RewardDynamics`` has no ``noise``, which the constructor reads).
    """

    def __init__(self, base: MLPDynamics, n_ensemble: int = 5):
        self.base = base
        self.n = n_ensemble
        self.state_dim = base.state_dim
        self.action_dim = base.action_dim
        self.noise = base.noise
        self._fused = type(base) is MLPDynamics

    def init(self, generator: torch.Generator, device=None):
        device = resolve_device(device)
        return _stack([self.base.init(generator, device)
                       for _ in range(self.n)])

    def _inputs(self, state, action, normalizers):
        n = normalizers or Normalizers()
        return n, torch.cat([n.norm_state(state), n.norm_action(action)],
                            dim=-1)

    def _members(self, params, states, actions, normalizers):
        """Each member i's base forward on (states[i], actions[i]),
        stacked: (n, ...)."""
        return torch.stack([
            self.base.forward(_member(params, i), states[i], actions[i],
                              normalizers) for i in range(self.n)])

    def forward_all(self, params, state, action,
                    normalizers: Optional[Normalizers] = None,
                    generator: Optional[torch.Generator] = None):
        """Every member on every row: (..., dim) -> (n, ..., sd).
        ``generator`` is ignored here and in ``forward`` and
        ``forward_ts``, as JAX ignores its key."""
        if not self._fused:
            return self._members(params, [state] * self.n,
                                 [action] * self.n, normalizers)
        n, x = self._inputs(state, action, normalizers)
        flat = x.reshape(-1, x.shape[-1]).expand(self.n, -1, -1)
        out = _stacked_net(params, flat)
        return n.unnorm_state(out.reshape((self.n,) + x.shape[:-1] + (-1,)))

    def forward(self, params, state, action,
                normalizers: Optional[Normalizers] = None,
                generator: Optional[torch.Generator] = None):
        return self.forward_all(params, state, action, normalizers).mean(0)

    def forward_ts(self, params, state, action,
                   normalizers: Optional[Normalizers] = None,
                   generator: Optional[torch.Generator] = None):
        """TS-infinity: state/action (N, dim), row k -> member k % n; the
        ensemble mean when N is not divisible by n (as in JAX).

        JAX reads N from the leading axis whatever the rank: a single
        state (sd,) takes the mean when sd % n != 0 and fails when it
        divides (the action cannot take the state's reshape); the port
        raises there too."""
        N = state.shape[0]
        if N % self.n:
            return self.forward(params, state, action, normalizers)
        if state.ndim == 1:
            raise TypeError(
                f'EnsembleDynamics.forward_ts got a single state of {N} '
                f'dims, divisible by the {self.n} members: JAX reshapes '
                f'the state to ({N // self.n}, {self.n}, -1) and fails on '
                f'the ({action.shape[0]},) action (cannot reshape; '
                'mujoco_mbrl_tpu.models.dynamics.EnsembleDynamics.'
                'forward_ts)')
        group = lambda t: t.reshape(N // self.n, self.n, -1).transpose(0, 1)
        if not self._fused:
            out = self._members(params, group(state), group(action),
                                normalizers)            # (n, N / n, sd)
            return out.transpose(0, 1).reshape(N, -1)
        n, x = self._inputs(state, action, normalizers)
        out = _stacked_net(params, group(x))            # (n, N / n, sd)
        return n.unnorm_state(out.transpose(0, 1).reshape(N, -1))

    def loss(self, params, batch, normalizers: Optional[Normalizers] = None,
             generator: Optional[torch.Generator] = None):
        """Sum of the members' base losses; with a generator each member
        sees its own bootstrap resample (rows drawn with replacement) of
        every field of the batch."""
        nm = normalizers or Normalizers()
        B = batch['states'].shape[0]
        idx = None
        if generator is not None:
            idx = torch.randint(0, B, (self.n, B), generator=generator,
                                device=generator.device).to(
                                    batch['states'].device)
        if not self._fused:
            total = 0.0
            for i in range(self.n):
                rows = (batch if idx is None
                        else {k: v[idx[i]] for k, v in batch.items()})
                total = total + self.base.loss(_member(params, i), rows,
                                               normalizers)
            return total
        fields = ('states', 'actions', 'next_states')
        if idx is None:
            rows = {k: batch[k].expand((self.n,) + batch[k].shape)
                    for k in fields}
        else:
            rows = {k: batch[k][idx] for k in fields}
        x = torch.cat([nm.norm_state(rows['states']),
                       nm.norm_action(rows['actions'])], dim=-1)
        pred = _stacked_net(params, x.reshape(self.n, -1, x.shape[-1]))
        target = nm.norm_state(rows['next_states'])
        pred = pred.reshape(target.shape)               # (n, B, h, sd)
        per_step = torch.mean((pred - target) ** 2,
                              dim=(1,) + tuple(range(3, pred.ndim)))
        return per_step.sum()
