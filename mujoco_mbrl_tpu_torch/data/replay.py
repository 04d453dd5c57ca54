"""Rollout ring buffer with running normalization stats.

Port of mujoco_mbrl_tpu/data/replay.py. Rollouts have a fixed length, so
storage is a preallocated ``(capacity_rollouts, T, dim)`` ring on one
device; eviction is an index wrap. Unlike the JAX buffer, whose arrays are
immutable, ``add_rollouts`` writes the ring in place and returns the same
storage (the agent owns its one buffer). ``cursor`` and ``filled`` are
host integers, so no call here waits on the device. Statistics {mean,
std, min, max} per field are recomputed over the filled rows on every add
(the ``n - 1`` variance of the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Rollouts:
    """A batch of fixed-length rollouts: states / observations have T + 1
    entries, actions / rewards T."""
    states: torch.Tensor        # (B, T+1, state_dim)
    observations: torch.Tensor  # (B, T+1, obs_dim)
    actions: torch.Tensor       # (B, T, act_dim)
    rewards: torch.Tensor       # (B, T)

    @property
    def length(self) -> int:
        return self.actions.shape[-2]

    def sum_of_rewards(self) -> torch.Tensor:
        return self.rewards.sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class Stats:
    mean: torch.Tensor
    std: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    states: torch.Tensor        # (R, T+1, state_dim)
    observations: torch.Tensor  # (R, T+1, obs_dim)
    actions: torch.Tensor       # (R, T, act_dim)
    rewards: torch.Tensor       # (R, T)
    cursor: int                 # next write slot
    filled: int                 # number of valid rollouts
    stats: Dict[str, Stats]

    @property
    def capacity_rollouts(self) -> int:
        return self.states.shape[0]

    @property
    def rollout_length(self) -> int:
        return self.actions.shape[1]

    def replace(self, **kw) -> 'ReplayBuffer':
        return dataclasses.replace(self, **kw)


_FIELDS = ('states', 'observations', 'actions', 'rewards')


def _field_stats(x: torch.Tensor, filled: int) -> Stats:
    """Per-dim stats over the first `filled` rows of (R, T, dim)."""
    valid = x[:filled]
    dims = tuple(range(x.ndim - 1))
    n = max(filled * math.prod(x.shape[1:-1]), 1)
    mean = valid.sum(dim=dims) / n
    var = ((valid - mean) ** 2).sum(dim=dims) / max(n - 1, 1)
    if filled:
        mn, mx = valid.amin(dim=dims), valid.amax(dim=dims)
    else:
        mn = torch.full_like(mean, float('inf'))
        mx = torch.full_like(mean, -float('inf'))
    return Stats(mean=mean, std=torch.sqrt(var), min=mn, max=mx)


def compute_stats(buf: ReplayBuffer) -> Dict[str, Stats]:
    return {
        'states': _field_stats(buf.states, buf.filled),
        'observations': _field_stats(buf.observations, buf.filled),
        'actions': _field_stats(buf.actions, buf.filled),
        'rewards': _field_stats(buf.rewards[..., None], buf.filled),
    }


def init_replay(capacity_rollouts: int, rollout_length: int,
                state_dim: int, obs_dim: int, act_dim: int,
                dtype=torch.float32, device=None) -> ReplayBuffer:
    """An empty ring of ``capacity_rollouts`` rollouts of
    ``rollout_length`` steps on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    R, T = capacity_rollouts, rollout_length
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    buf = ReplayBuffer(states=zeros(R, T + 1, state_dim),
                       observations=zeros(R, T + 1, obs_dim),
                       actions=zeros(R, T, act_dim), rewards=zeros(R, T),
                       cursor=0, filled=0, stats={})
    return buf.replace(stats=compute_stats(buf))


def add_rollouts(buf: ReplayBuffer, rolls: Rollouts) -> ReplayBuffer:
    """Write a batch of rollouts at the ring cursor (in place); refresh
    stats. When the batch is larger than the ring, its last R rollouts
    are the ones kept (JAX leaves the winner of a repeated index
    unspecified)."""
    B = rolls.actions.shape[0]
    R = buf.capacity_rollouts
    keep = min(B, R)
    first = (buf.cursor + B - keep) % R
    idx = (first + torch.arange(keep, device=buf.states.device)) % R
    for name in _FIELDS:
        getattr(buf, name)[idx] = getattr(rolls, name)[B - keep:].to(
            getattr(buf, name).dtype)
    buf = buf.replace(cursor=(buf.cursor + B) % R,
                      filled=min(buf.filled + B, R))
    return buf.replace(stats=compute_stats(buf))


def num_transitions(buf: ReplayBuffer, horizon: int = 1) -> int:
    return buf.filled * (buf.rollout_length - horizon + 1)


def gather_windows(buf: ReplayBuffer, roll_idx: torch.Tensor,
                   start: torch.Tensor, horizon: int):
    """Windows of `horizon` transitions at (roll_idx, start), each (N,):
    dict of states / observations / actions (N, h, dim), rewards (N, h),
    next_states / next_observations (N, h, dim)."""
    dev = buf.states.device
    ri = roll_idx.to(dev)[:, None]
    t = start.to(dev)[:, None] + torch.arange(horizon + 1, device=dev)
    s = buf.states[ri, t]
    o = buf.observations[ri, t]
    return dict(states=s[:, :-1], observations=o[:, :-1],
                actions=buf.actions[ri, t[:, :-1]],
                rewards=buf.rewards[ri, t[:, :-1]],
                next_states=s[:, 1:], next_observations=o[:, 1:])


def sample_transitions(buf: ReplayBuffer, generator: torch.Generator,
                       batch_size: int, horizon: int = 1):
    """Uniformly sampled windows (see ``gather_windows``)."""
    per_roll = buf.rollout_length - horizon + 1
    roll_idx = torch.randint(0, max(buf.filled, 1), (batch_size,),
                             generator=generator, device=generator.device)
    start = torch.randint(0, per_roll, (batch_size,), generator=generator,
                          device=generator.device)
    return gather_windows(buf, roll_idx, start, horizon)


def epoch_batches(buf: ReplayBuffer, generator: torch.Generator,
                  batch_size: int, horizon: int = 1):
    """Every valid (rollout, start) pair once, shuffled, in fixed batches.

    The permutation covers the full (R * per_roll) grid; entries of
    unfilled rollouts are remapped onto uniformly drawn filled ones, so the
    batch count does not depend on the fill (replay.py:184-218). Returns
    (roll_idx, start), each (num_batches, batch_size), on the generator's
    device.
    """
    per_roll = max(buf.rollout_length - horizon + 1, 1)
    total = buf.capacity_rollouts * per_roll
    perm = torch.randperm(total, generator=generator,
                          device=generator.device)
    roll_idx, start = perm // per_roll, perm % per_roll
    filled = max(buf.filled, 1)
    rand_valid = torch.floor(torch.rand(total, generator=generator,
                                        device=generator.device) * filled)
    rand_valid = torch.clamp(rand_valid.to(roll_idx.dtype), max=filled - 1)
    roll_idx = torch.where(roll_idx < filled, roll_idx, rand_valid)
    nb = total // batch_size
    return (roll_idx[:nb * batch_size].reshape(nb, batch_size),
            start[:nb * batch_size].reshape(nb, batch_size))


def normalize(value: torch.Tensor, stats: Stats,
              eps: float = 1e-6) -> torch.Tensor:
    return (value - stats.mean) / (stats.std + eps)


def unnormalize(value: torch.Tensor, stats: Stats,
                eps: float = 1e-6) -> torch.Tensor:
    return value * (stats.std + eps) + stats.mean


def as_tree(buf: ReplayBuffer) -> Dict[str, object]:
    """The buffer as a plain dict (tensors and ints) for checkpoints."""
    return {**{k: getattr(buf, k) for k in _FIELDS},
            'cursor': buf.cursor, 'filled': buf.filled}


def from_tree(tree, device: Optional[torch.device] = None) -> ReplayBuffer:
    """Inverse of ``as_tree``; stats are recomputed."""
    buf = ReplayBuffer(**{k: tree[k].to(device or tree[k].device)
                          for k in _FIELDS},
                       cursor=int(tree['cursor']),
                       filled=int(tree['filled']), stats={})
    return buf.replace(stats=compute_stats(buf))
