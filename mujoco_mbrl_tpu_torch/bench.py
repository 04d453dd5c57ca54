"""The MPC control step: batched CEM over the model, then the physics step.

Port of ``bench.py:build_bench`` (defaults of its ``main``): walker_walk
envs in lockstep, CEM with K candidates, horizon H and ``cem_iters``
refits over a 50-hidden MLP dynamics model with random weights from a
seed (goal e_1, unit cost weights, K // 10 elites), then one batched
``env.step`` of 10 physics substeps. ``model_kind='ensemble'`` plans
through an ``n_ensemble``-member ensemble with TS-infinity propagation
instead (the walker_ens configuration). The sampler kernel runs
``cem_iters`` times and the APGD kernel once per substep per control step.
``chip_smoke.py`` drives it on the card.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from . import models, suite
from .device import resolve_device
from .ops.cem_rollout import (mlp_sample_rollout_costs,
                              mlp_sample_rollout_costs_ensemble)
from .planners import cem_batched


def build_bench(task: str, B: int, K: int, H: int, cem_iters: int,
                steps: int, sampler: str = 'triangular', device=None,
                model_kind: str = 'mlp', n_ensemble: int = 5):
    """Returns ``(run, (params, state0, generator))``.

    ``run(params, env_state, generator, profile=None)`` drives ``steps``
    control steps and returns ``(env_state, mean reward per step)``; with
    a ``profile`` dict it synchronizes around each phase and adds the
    seconds spent planning and stepping physics under 'plan' / 'physics'.
    """
    dev = resolve_device(device)
    domain, task_name = task.rsplit('_', 1)
    env = suite.load(domain, task_name, device=dev)
    state0, ts0 = env.reset(B, torch.Generator().manual_seed(0))
    obs_dim = suite.flatten_observation(ts0.observation).shape[1]
    act_dim = env.model.nu
    model = models.MLPDynamics(obs_dim, act_dim, hidden_units=50)
    if model_kind == 'ensemble':
        model = models.EnsembleDynamics(model, n_ensemble)
    elif model_kind != 'mlp':
        raise ValueError(f'unknown model_kind {model_kind!r}')
    params = model.init(torch.Generator().manual_seed(1), device=dev)
    goal = torch.zeros(obs_dim, device=dev)
    goal[1] = 1.0
    weights = torch.ones(obs_dim, device=dev)

    def plan_batch(params, obs, seeds):
        def scf(seed, mean, std):
            if model_kind == 'ensemble':
                return mlp_sample_rollout_costs_ensemble(
                    params, seed, obs, mean, std, goal, weights,
                    num_candidates=K, n_members=n_ensemble, sampler=sampler)
            return mlp_sample_rollout_costs(params, seed, obs, mean, std,
                                            goal, weights, num_candidates=K,
                                            sampler=sampler)
        traj = cem_batched(seeds, obs, horizon=H, action_dim=act_dim,
                           num_candidates=K, num_elites=max(K // 10, 1),
                           sample_costs_fn=scf)
        return traj.actions[0]

    def timed(profile: Optional[Dict[str, float]], key: str, fn):
        if profile is None:
            return fn()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        profile[key] = profile.get(key, 0.0) + time.perf_counter() - t0
        return out

    def run(params, env_state, generator: torch.Generator,
            profile: Optional[Dict[str, float]] = None):
        # the observation of each later step comes from env.step's TimeStep
        obs = suite.flatten_observation(env._observe(
            env.model, env_state.physics, env_state.params))
        rewards = []
        for _ in range(steps):
            seeds = torch.randint(0, 2 ** 31 - 1, (cem_iters,),
                                  generator=generator).tolist()
            actions = timed(profile, 'plan',
                            lambda: plan_batch(params, obs, seeds))
            env_state, ts = timed(profile, 'physics',
                                  lambda: env.step(env_state, actions))
            obs = suite.flatten_observation(ts.observation)
            rewards.append(ts.reward.mean())
        return env_state, torch.stack(rewards)

    return run, (params, state0, torch.Generator().manual_seed(2))

