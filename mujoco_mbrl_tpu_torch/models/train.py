"""Model fitting: ``train_model`` / ``evaluate_model``.

Port of mujoco_mbrl_tpu/models/train.py. Every epoch visits each stored
(rollout, start) once in shuffled minibatches (``data.replay.epoch_batches``),
with plain PyTorch autograd and a ``torch.optim`` optimizer in place of
optax; the JAX package has no Pallas kernel here. An epoch is two steps so
that a caller can supply the indices: ``data.replay.epoch_batches`` draws
them, ``fit_epoch`` runs the minibatches.

Every model family fits through the same loop: a ``loss`` that returns
``(loss, aux)`` (``RewardDynamics``) contributes its first element, and
windows of ``horizon`` transitions reach the model as (B, h, dim) fields
(the ``RNNDynamics`` sequences).

Optimizers (``adam`` / ``sgd``) are factories over the parameter leaves.
``torch.optim.Adam`` and ``optax.adam`` are the same update: bias-corrected
moments with betas (0.9, 0.999) and eps = 1e-8 added outside the square
root (optax's ``eps_root`` is 0); only the float rounding differs.
Parameters are updated in place, so the tree passed in is the tree
returned.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..data import replay as R
from .dynamics import Normalizers


class TrainLog(NamedTuple):
    losses: torch.Tensor       # (num_updates,) per-minibatch loss
    final_loss: torch.Tensor


def adam(lr: float = 0.01) -> Callable:
    """Factory: ``adam(lr)(leaves)`` is ``torch.optim.Adam`` (optax.adam)."""
    return functools.partial(torch.optim.Adam, lr=lr)


def sgd(lr: float = 0.1) -> Callable:
    """Factory: ``sgd(lr)(leaves)`` is ``torch.optim.SGD`` (optax.sgd)."""
    return functools.partial(torch.optim.SGD, lr=lr)


def param_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict in sorted-key order (JAX's order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]


def make_normalizers(buf: R.ReplayBuffer,
                     use_observations: bool = True) -> Normalizers:
    """Forward-time normalizers from the buffer's stats; the model's
    'state' is the observation (obs_only) or the featured state."""
    s = buf.stats['observations' if use_observations else 'states']
    a, r = buf.stats['actions'], buf.stats['rewards']
    return Normalizers(state_mean=s.mean, state_std=s.std,
                       action_mean=a.mean, action_std=a.std,
                       reward_mean=r.mean, reward_std=r.std)


def _batch_from_windows(win: Dict[str, torch.Tensor], obs_only: bool):
    if obs_only:
        return dict(states=win['observations'], actions=win['actions'],
                    rewards=win['rewards'],
                    next_states=win['next_observations'])
    return dict(states=win['states'], actions=win['actions'],
                rewards=win['rewards'], next_states=win['next_states'])


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def fit_epoch(model, params, buf: R.ReplayBuffer, optimizer,
              roll_idx: torch.Tensor, start: torch.Tensor,
              horizon: int = 1, obs_only: bool = True,
              normalizers: Optional[Normalizers] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One optimizer step per row of ``roll_idx`` / ``start``
    (num_batches, batch_size); returns the minibatch losses."""
    losses = []
    for ri, st in zip(roll_idx, start):
        batch = _batch_from_windows(
            R.gather_windows(buf, ri, st, horizon), obs_only)
        optimizer.zero_grad(set_to_none=True)
        # the ensemble bootstraps from the generator, as JAX hands its key
        # on; a loss may return (loss, aux), of which the fit takes loss
        loss = _first(model.loss(params, batch, normalizers,
                                 generator=generator))
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    if not losses:
        return torch.zeros((0,), device=buf.states.device)
    return torch.stack(losses)


def train_model(model, params, buf: R.ReplayBuffer,
                generator: torch.Generator, optimizer=None,
                batch_size: int = 512, num_epochs: int = 50,
                horizon: int = 1, obs_only: bool = True,
                normalizers: Optional[Normalizers] = None
                ) -> Tuple[Any, Any, TrainLog]:
    """Fit `model` on the replay buffer; returns (params, optimizer, log).

    ``optimizer`` is a ``torch.optim`` optimizer over ``param_leaves(
    params)`` (default: Adam, lr 0.01, as the JAX default); the params are
    updated in place. The ensemble's bootstrap draws come from
    ``generator``, as do the epoch permutations.
    """
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    if optimizer is None:
        optimizer = adam()(leaves)
    losses = []
    for _ in range(num_epochs):
        roll_idx, start = (i.to(buf.states.device) for i in R.epoch_batches(
            buf, generator, batch_size, horizon))
        losses.append(fit_epoch(model, params, buf, optimizer, roll_idx,
                                start, horizon, obs_only, normalizers,
                                generator))
    losses = torch.cat(losses)
    final = losses[-1] if len(losses) else torch.zeros(())
    return params, optimizer, TrainLog(losses=losses, final_loss=final)


@torch.no_grad()
def evaluate_model(model, params, buf: R.ReplayBuffer,
                   generator: torch.Generator, batch_size: int = 512,
                   horizon: int = 1, obs_only: bool = True,
                   normalizers: Optional[Normalizers] = None
                   ) -> torch.Tensor:
    """Mean MSE over sampled transitions."""
    win = R.sample_transitions(buf, generator, batch_size, horizon)
    return _first(model.loss(params, _batch_from_windows(win, obs_only),
                             normalizers))
