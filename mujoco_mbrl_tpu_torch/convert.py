"""Carry the JAX package's parameters and state across, as numpy arrays.

The JAX side hands over ``jax.tree_util.tree_map(np.asarray, tree)``; this
module turns those arrays into the port's tensors so both packages can be
driven with identical inputs.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .data.replay import ReplayBuffer, Rollouts, compute_stats
from .models.dynamics import Normalizers
from .physics.model import State
from .suite.control import EnvState


def tensor(x, device='cpu', dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def mlp_params(params: Mapping[str, Mapping[str, Any]], device='cpu'):
    """MLP param tree {'l1','l2','l3'} x {'w','b'} (w stored (in, out))."""
    return dense_params(params, ('l1', 'l2', 'l3'), device)


def dense_params(params: Mapping[str, Mapping[str, Any]], layers,
                 device='cpu'):
    """A tree of dense layers {layer: {'w', 'b'}} (w stored (in, out)), the
    layout every model family shares: ``mlp_params``' ('l1', 'l2', 'l3'),
    ``LinearDynamics``' ('l1',), ``RewardDynamics``' (``REWARD_LAYERS``),
    ``RNNDynamics``' (``RNN_LAYERS``)."""
    return {layer: {k: tensor(params[layer][k], device) for k in ('w', 'b')}
            for layer in layers}


REWARD_LAYERS = ('l1', 'l2', 'state_head', 'reward_head')
RNN_LAYERS = ('gru_rz', 'gru_n', 'head1', 'head2')


def ensemble_params(params: Mapping[str, Mapping[str, Any]], device='cpu'):
    """EnsembleDynamics params: the MLP tree with a leading member axis
    (w (n, in, out), b (n, out))."""
    if np.ndim(params['l1']['w']) != 3:
        raise ValueError('ensemble params carry a leading member axis')
    return mlp_params(params, device)


def rollouts(rolls: Any, device='cpu') -> Rollouts:
    """From a JAX ``Rollouts`` whose fields are arrays."""
    return Rollouts(**{k: tensor(getattr(rolls, k), device) for k in
                       ('states', 'observations', 'actions', 'rewards')})


def replay_buffer(buf: Any, device='cpu') -> ReplayBuffer:
    """From a JAX ``ReplayBuffer`` whose fields are arrays; the stats are
    recomputed by the port."""
    out = ReplayBuffer(
        **{k: tensor(getattr(buf, k), device) for k in
           ('states', 'observations', 'actions', 'rewards')},
        cursor=int(np.asarray(buf.cursor)), filled=int(np.asarray(buf.filled)),
        stats={})
    return out.replace(stats=compute_stats(out))


_NORM_FIELDS = ('state_mean', 'state_std', 'action_mean', 'action_std',
                'reward_mean', 'reward_std')


def normalizers(norm: Any, device='cpu') -> Normalizers:
    """From a JAX ``Normalizers`` whose fields are arrays or None."""
    return Normalizers(**{
        k: None if getattr(norm, k) is None else tensor(getattr(norm, k),
                                                        device)
        for k in _NORM_FIELDS})


def env_state(qpos, qvel, act=None, time=None, step_count=None,
              device='cpu') -> EnvState:
    """Batched EnvState from per-env arrays: qpos (B, nq), qvel (B, nv),
    act (B, na) (empty or None: no activation state), time (B,),
    step_count (B,)."""
    qpos = tensor(qpos, device)
    B = qpos.shape[0]
    act = (tensor(act, device) if act is not None and np.asarray(act).size
           else None)
    time = (torch.zeros((B,), device=device) if time is None
            else tensor(time, device))
    steps = (torch.zeros((B,), dtype=torch.int32, device=device)
             if step_count is None
             else tensor(step_count, device, torch.int32))
    return EnvState(physics=State(qpos=qpos, qvel=tensor(qvel, device),
                                  time=time, act=act),
                    params=(), step_count=steps,
                    last=torch.zeros((B,), dtype=torch.bool, device=device))
