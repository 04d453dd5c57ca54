"""Carry the JAX package's parameters and state across, as numpy arrays.

The JAX side hands over ``jax.tree_util.tree_map(np.asarray, tree)``; this
module turns those arrays into the port's tensors so both packages can be
driven with identical inputs: parameters, replay buffers, env states (a
composed env's too: its task params, such as ``RandomizedPitch`` ratios or
``GoToTarget`` targets, and the observation pipeline's buffers) and the
pipeline's ``BufferState``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .data.replay import ReplayBuffer, Rollouts, compute_stats
from .models.dynamics import Normalizers
from .observation import BufferState
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
    """EnsembleDynamics params over any dense base: the base's tree (MLP,
    linear, reward or GRU layers) with a leading member axis (w (n, in,
    out), b (n, out)), as JAX's vmap over the members stacks it."""
    if any(np.ndim(p['w']) != 3 for p in params.values()):
        raise ValueError('ensemble params carry a leading member axis')
    return dense_params(params, tuple(params), device)


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


def tree(x, device='cpu'):
    """Arrays of a nested dict / tuple / list to tensors: floats to
    float32, integers to int32, booleans kept; None and the structure
    kept."""
    if isinstance(x, dict):
        return {k: tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(tree(v, device) for v in x)
    if x is None:
        return None
    a = np.asarray(x)
    dtype = (torch.bool if a.dtype == np.bool_ else torch.int32
             if np.issubdtype(a.dtype, np.integer) else torch.float32)
    return tensor(a, device, dtype)


def buffer_state(st: Any, device='cpu') -> BufferState:
    """From a JAX ``BufferState`` of a batch of envs (vmapped): pending
    (B, delay+1, ...), ring (B, buffer_size, ...), step (B,)."""
    return BufferState(pending=tensor(st.pending, device),
                       ring=tensor(st.ring, device),
                       step=tensor(st.step, device, torch.int32))


def key_seed(key) -> int:
    """An integer seed from a JAX PRNG key's words."""
    words = np.asarray(key).astype(np.uint64).reshape(-1)
    return int(words[-1] | (words[0] << np.uint64(32))) & (2 ** 62 - 1)


def composed_env_state(state: Any, device='cpu'):
    """From a JAX env state of a batch of envs (vmapped): a control
    ``EnvState`` with its task params converted by :func:`tree`, or a
    ``BufferedEnvironment``'s dict (``inner``, ``buffers``, ``key``). The
    pipeline's corruptor key becomes an integer seed: the two packages'
    noise streams differ in any case."""
    if isinstance(state, dict):
        return dict(inner=composed_env_state(state['inner'], device),
                    buffers={k: buffer_state(v, device)
                             for k, v in state['buffers'].items()},
                    key=key_seed(np.asarray(state['key'])[0]))
    base = env_state(state.physics.qpos, state.physics.qvel,
                     act=getattr(state.physics, 'act', None),
                     time=state.physics.time, step_count=state.step_count,
                     device=device)
    return EnvState(physics=base.physics, params=tree(state.params, device),
                    step_count=base.step_count,
                    last=tensor(state.last, device, torch.bool))
