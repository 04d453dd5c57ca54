"""The MPC control step and the full MBRL iteration, as the JAX bench runs
them.

Port of ``bench.py``'s ``build_bench`` (defaults of its ``main``),
``full_loop_bench`` and the ``CONFIGS`` presets that the port runs.

``build_bench``: envs in lockstep (walker_walk, cheetah_run, hopper_hop,
reacher_easy, cartpole_swingup, ...), CEM with K candidates, horizon H and
``cem_iters`` refits over a
50-hidden MLP dynamics model with random weights from a seed (goal e_1,
unit cost weights, K // 10 elites), then one batched ``env.step``
(walker: 10 physics substeps and 10 dense APGD launches; cheetah: 1
substep and 1 factored APGD launch; humanoid_walk: 5 substeps and 5
factored APGD launches on the block path, 303 rows; hopper_hop: 4
substeps and the observation's forward, each a dense APGD launch on the
block path, 88 rows; reacher_easy: 1 substep and 1 dense APGD launch for
its one limit row; cartpole_swingup: 1 RK4 step, 4 one-row APGD
launches). The candidates take the JAX bench's route (``bench.py:78``):
the fused sampler when obs_dim + act_dim >= 16 (walker, cheetah, hopper's
15 + 4, humanoid's 67 + 21), else ``cem_batched``'s model / cost scan in
plain PyTorch (reacher: 6 + 2, cartpole: 5 + 1). ``fused=True`` forces
the sampler;
``fused=False`` takes ``cem_batched``'s non-fused branch instead:
candidates drawn with ``torch.randn``, costed by the rollout-cost kernel
(``ops.mlp_rollout_costs_t``), one launch per CEM iteration.
``model_kind='ensemble'`` plans through an ``n_ensemble``-member ensemble
with TS-infinity propagation (the walker_ens configuration).

``full_loop_bench``: the complete MBRL iteration, collect (MPC through
the fused sampler) -> replay add with a stats refresh -> fit, after a
seed collection with random actions (the cheetah1024 milestone,
``CONFIGS['cheetah1024']``).

``chip_smoke.py`` drives both on the card.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from . import data, models, suite
from .device import resolve_device
from .models import train as T
from .ops.cem_rollout import (mlp_rollout_costs_t, mlp_sample_rollout_costs,
                              mlp_sample_rollout_costs_ensemble)
from .planners import cem_batched

# the JAX bench's milestone presets (BASELINE.json configs), all ported
CONFIGS = {
    'northstar': dict(task='walker_walk', envs=1024, candidates=1000,
                      horizon=30),
    'cartpole': dict(task='cartpole_swingup', envs=128, candidates=1000,
                     horizon=30),
    'cheetah1024': dict(task='cheetah_run', envs=1024, candidates=1000,
                        horizon=30, full_loop=True),
    'walker_ens': dict(task='walker_walk', envs=1024, candidates=1000,
                       horizon=30, model='ensemble'),
    'reacher256': dict(task='reacher_easy', envs=256, candidates=500,
                       horizon=20),
    'humanoid': dict(task='humanoid_walk', envs=512, candidates=1000,
                     horizon=30),
}
# the JAX bench's rule: the fused sampler only where the feature dims carry
# real work (bench.py:78); smaller models plan through the scan
FUSED_MIN_DIMS = 16


def config(name: str) -> dict:
    """The preset ``name`` of the JAX bench (``bench.py`` CONFIGS)."""
    return dict(CONFIGS[name])


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _timed(dev, profile: Optional[Dict[str, float]], key: str, fn):
    """``fn()``; with a ``profile`` dict, synchronize around it and add
    its seconds under ``key``."""
    if profile is None:
        return fn()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    profile[key] = profile.get(key, 0.0) + time.perf_counter() - t0
    return out


def _setup(task: str, B: int, dev):
    domain, task_name = task.rsplit('_', 1)
    env = suite.load(domain, task_name, device=dev)
    state0, ts0 = env.reset(B, torch.Generator().manual_seed(0))
    obs_dim = suite.flatten_observation(ts0.observation).shape[1]
    goal = torch.zeros(obs_dim, device=dev)
    goal[1] = 1.0
    return env, state0, obs_dim, env.model.nu, goal, torch.ones(
        obs_dim, device=dev)


def _observe(env, env_state) -> torch.Tensor:
    return suite.flatten_observation(env._observe(
        env._model_with(env_state.params), env_state.physics,
        env_state.params))


def build_bench(task: str, B: int, K: int, H: int, cem_iters: int,
                steps: int, sampler: str = 'triangular', device=None,
                model_kind: str = 'mlp', n_ensemble: int = 5,
                fused: Optional[bool] = None):
    """Returns ``(run, (params, state0, generator))``.

    ``run(params, env_state, generator, profile=None)`` drives ``steps``
    control steps and returns ``(env_state, mean reward per step)``; with
    a ``profile`` dict it synchronizes around each phase and adds the
    seconds spent planning and stepping physics under 'plan' / 'physics'.
    """
    dev = resolve_device(device)
    env, state0, obs_dim, act_dim, goal, weights = _setup(task, B, dev)
    model = models.MLPDynamics(obs_dim, act_dim, hidden_units=50)
    if model_kind == 'ensemble':
        model = models.EnsembleDynamics(model, n_ensemble)
    elif model_kind != 'mlp':
        raise ValueError(f'unknown model_kind {model_kind!r}')
    scan = fused is None and obs_dim + act_dim < FUSED_MIN_DIMS
    if fused is None:
        fused = not scan
    if not fused and not scan and model_kind != 'mlp':
        raise ValueError('the non-fused path costs a single MLP')
    params = model.init(torch.Generator().manual_seed(1), device=dev)
    forward = (model.forward_ts if model_kind == 'ensemble'
               else model.forward)

    def cost(states, actions):
        return (models.smooth_abs_loss(states, goal, weights)
                + models.cosh_loss(actions))

    def plan_batch(params, obs, seeds):
        def scf(seed, mean, std):
            if model_kind == 'ensemble':
                return mlp_sample_rollout_costs_ensemble(
                    params, seed, obs, mean, std, goal, weights,
                    num_candidates=K, n_members=n_ensemble, sampler=sampler)
            return mlp_sample_rollout_costs(params, seed, obs, mean, std,
                                            goal, weights, num_candidates=K,
                                            sampler=sampler)

        def rc(s0T, actionsT):
            return mlp_rollout_costs_t(params, s0T, actionsT, goal, weights)
        traj = cem_batched(seeds, obs, horizon=H, action_dim=act_dim,
                           num_candidates=K, num_elites=max(K // 10, 1),
                           sample_costs_fn=scf if fused else None,
                           rollout_costs_fn=None if fused or scan else rc,
                           model=lambda s, a: forward(params, s, a),
                           cost=cost)
        return traj.actions[0]

    def run(params, env_state, generator: torch.Generator,
            profile: Optional[Dict[str, float]] = None):
        # the observation of each later step comes from env.step's TimeStep
        obs = _observe(env, env_state)
        rewards = []
        for _ in range(steps):
            seeds = torch.randint(0, 2 ** 31 - 1, (cem_iters,),
                                  generator=generator).tolist()
            actions = _timed(dev, profile, 'plan',
                             lambda: plan_batch(params, obs, seeds))
            env_state, ts = _timed(dev, profile, 'physics',
                                   lambda: env.step(env_state, actions))
            obs = suite.flatten_observation(ts.observation)
            rewards.append(ts.reward.mean())
        return env_state, torch.stack(rewards)

    return run, (params, state0, torch.Generator().manual_seed(2))


def full_loop_bench(task: str, B: int, K: int, H: int, cem_iters: int,
                    steps: int, repeats: int = 1, sampler: str = 'triangular',
                    device=None, train_epochs: int = 50,
                    train_batch: int = 512) -> Dict[str, object]:
    """Time the complete MBRL iteration (JAX ``bench.py:full_loop_bench``):
    collect ``B`` rollouts of ``steps`` control steps with CEM K x H x
    ``cem_iters`` MPC over a 50-hidden MLP (the fused sampler, the
    replay's normalizers folded in) -> replay add with a stats refresh ->
    fit ``train_epochs`` epochs at batch ``train_batch`` (Adam 0.01). The
    replay holds 2 B rollouts (obs_only). A seed collection with uniform
    random actions from the reset states fills it first, outside the
    timing.

    Each of ``repeats`` iterations continues from the last (the params
    are fitted in place); the result reports the fastest. Returns a dict:
    ``env_steps_per_s`` (B * steps over the iteration's seconds, training
    included, as the JAX bench reports it), ``iteration_s``, the phase
    seconds ``collect_s`` / ``add_s`` / ``fit_s`` of that iteration,
    ``reset_s`` and ``seed_collect_s``, ``losses`` (the last fit's
    per-update losses), ``final_loss`` and the final env state.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    env, state0, obs_dim, act_dim, goal, weights = _setup(task, B, dev)
    _sync(dev)
    reset_s = time.perf_counter() - t0
    model = models.MLPDynamics(obs_dim, act_dim, hidden_units=50)
    params = model.init(torch.Generator().manual_seed(1), device=dev)
    gen = torch.Generator().manual_seed(3)
    optimizer = T.adam(0.01)(T.param_leaves(params))
    buf = data.init_replay(2 * B, steps, obs_dim, obs_dim, act_dim,
                           device=dev)

    def plan_batch(norms, obs):
        seeds = torch.randint(0, 2 ** 31 - 1, (cem_iters,),
                              generator=gen).tolist()
        traj = cem_batched(
            seeds, obs, horizon=H, action_dim=act_dim, num_candidates=K,
            num_elites=max(K // 10, 1),
            sample_costs_fn=lambda seed, mean, std: mlp_sample_rollout_costs(
                params, seed, obs, mean, std, goal, weights,
                normalizers=norms, num_candidates=K, sampler=sampler))
        return traj.actions[0]

    @torch.no_grad()
    def collect(env_state, norms, random_policy: bool):
        obs = _observe(env, env_state)
        obs_seq, act_seq, rew_seq = [obs], [], []
        for _ in range(steps):
            if random_policy:
                actions = (2.0 * torch.rand((B, act_dim), generator=gen)
                           - 1.0).to(dev)
            else:
                actions = plan_batch(norms, obs)
            env_state, ts = env.step(env_state, actions)
            obs = suite.flatten_observation(ts.observation)
            obs_seq.append(obs)
            act_seq.append(actions)
            rew_seq.append(ts.reward)
        obs_all = torch.stack(obs_seq, 1)                  # (B, T+1, d)
        return env_state, data.Rollouts(
            states=obs_all, observations=obs_all,
            actions=torch.stack(act_seq, 1), rewards=torch.stack(rew_seq, 1))

    t0 = time.perf_counter()
    env_state, rolls = collect(state0, None, random_policy=True)
    buf = data.add_rollouts(buf, rolls)
    _sync(dev)
    seed_collect_s = time.perf_counter() - t0

    best, log = None, None
    for _ in range(repeats):
        phases: Dict[str, float] = {}
        _sync(dev)
        t0 = time.perf_counter()
        norms = T.make_normalizers(buf)
        env_state, rolls = _timed(dev, phases, 'collect_s', lambda: collect(
            env_state, norms, random_policy=False))
        buf = _timed(dev, phases, 'add_s',
                     lambda: data.add_rollouts(buf, rolls))
        norms = T.make_normalizers(buf)
        _, optimizer, log = _timed(dev, phases, 'fit_s', lambda: T.train_model(
            model, params, buf, gen, optimizer=optimizer,
            batch_size=train_batch, num_epochs=train_epochs,
            normalizers=norms, obs_only=True))
        _sync(dev)
        phases['iteration_s'] = time.perf_counter() - t0
        if best is None or phases['iteration_s'] < best['iteration_s']:
            best = phases
    return dict(best, env_steps_per_s=B * steps / best['iteration_s'],
                reset_s=reset_s, seed_collect_s=seed_collect_s,
                losses=log.losses.detach(), final_loss=float(log.final_loss),
                env_state=env_state, params=params, replay=buf)
