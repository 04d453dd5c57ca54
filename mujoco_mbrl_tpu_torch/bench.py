"""The bench entry point: the MPC control step, the full MBRL iteration
and the agent's collector, as the JAX bench runs them.

Port of the JAX package's ``bench.py``: ``build_bench``,
``full_loop_bench``, ``agent_loop_bench``, ``phase_breakdown``,
``analytic_flops`` / ``mfu_report`` (against the H100's peaks),
``selfcheck`` / ``selfcheck_ensemble`` (the CUDA kernels against the plain
rollout cost of their own actions) and ``main``, its command line with the
``CONFIGS`` presets::

    python -m mujoco_mbrl_tpu_torch.bench --config northstar [--dtype bf16]
    python -m mujoco_mbrl_tpu_torch.bench --cpu --envs 4 --candidates 16 ...

It runs on the card; ``--cpu`` runs the plain versions on the CPU, and
without ``--cpu`` and with no CUDA device it exits non-zero. The last line
is the JAX bench's JSON line less ``vs_baseline`` (a TPU-era target).

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

``chip_smoke.py`` drives them and ``main`` on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import data, models, suite
from .device import resolve_device
from .models import train as T
from .ops.cem_rollout import (mlp_rollout_costs_reference,
                              mlp_rollout_costs_t, mlp_sample_rollout_costs,
                              mlp_sample_rollout_costs_ensemble)
from .planners import cem_batched

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, at 700 W): the
# roofline of the bench's mfu_* keys and of chip_smoke.py's bounds
PEAK_BF16_FLOPS = 989.4e12   # bf16 tensor cores
PEAK_TF32_FLOPS = 494.7e12   # TF32 tensor cores
PEAK_FP32_FLOPS = 66.9e12    # FP32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3

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
                fused: Optional[bool] = None, compute_dtype=None):
    """Returns ``(run, (params, state0, generator))``.

    ``run(params, env_state, generator, profile=None)`` drives ``steps``
    control steps and returns ``(env_state, mean reward per step)``; with
    a ``profile`` dict it synchronizes around each phase and adds the
    seconds spent planning and stepping physics under 'plan' / 'physics'.
    ``compute_dtype`` reaches the samplers only (torch.bfloat16: their
    bf16 mode), as in JAX; the scan and the non-fused route ignore it.
    """
    dev = resolve_device(device)
    env, state0, params, plan_batch = _planner(
        task, B, K, H, sampler, dev, model_kind, n_ensemble, fused,
        compute_dtype)

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


def _planner(task, B, K, H, sampler, dev, model_kind, n_ensemble, fused,
             compute_dtype):
    """The bench's envs at their reset states, the model's params and
    ``plan_batch(params, obs, seeds) -> actions (B, ad)``: one CEM call
    through the JAX bench's route."""
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
                    num_candidates=K, n_members=n_ensemble, sampler=sampler,
                    compute_dtype=compute_dtype)
            return mlp_sample_rollout_costs(params, seed, obs, mean, std,
                                            goal, weights, num_candidates=K,
                                            sampler=sampler,
                                            compute_dtype=compute_dtype)

        def rc(s0T, actionsT):
            return mlp_rollout_costs_t(params, s0T, actionsT, goal, weights)
        traj = cem_batched(seeds, obs, horizon=H, action_dim=act_dim,
                           num_candidates=K, num_elites=max(K // 10, 1),
                           sample_costs_fn=scf if fused else None,
                           rollout_costs_fn=None if fused or scan else rc,
                           model=lambda s, a: forward(params, s, a),
                           cost=cost)
        return traj.actions[0]
    return env, state0, params, plan_batch


def full_loop_bench(task: str, B: int, K: int, H: int, cem_iters: int,
                    steps: int, repeats: int = 1, sampler: str = 'triangular',
                    device=None, train_epochs: int = 50,
                    train_batch: int = 512,
                    compute_dtype=None) -> Dict[str, object]:
    """Time the complete MBRL iteration (JAX ``bench.py:full_loop_bench``):
    collect ``B`` rollouts of ``steps`` control steps with CEM K x H x
    ``cem_iters`` MPC over a 50-hidden MLP (the fused sampler, the
    replay's normalizers folded in) -> replay add with a stats refresh ->
    fit ``train_epochs`` epochs at batch ``train_batch`` (Adam 0.01). The
    replay holds 2 B rollouts (obs_only). ``compute_dtype`` reaches the
    sampler. A seed collection with uniform
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
                normalizers=norms, num_candidates=K, sampler=sampler,
                compute_dtype=compute_dtype))
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


def agent_loop_bench(task: str, B: int, K: int, H: int, cem_iters: int,
                     steps: int, repeats: int = 1,
                     device=None) -> Dict[str, object]:
    """Time the agent's collector (JAX ``bench.py:agent_loop_bench``):
    ``GoalStateAgent._policy_collect(B)`` on the domain's wrapper, the
    batched CEM K x H x ``cem_iters`` over a 50-hidden MLP in the featured
    state with the domain's goal weights, B rollouts of ``steps`` control
    steps; one warm-up collection, then the best of ``repeats``. Returns
    the JAX bench's record (metric, value in env-steps/s, unit)."""
    from . import agents, envs, planners
    dev = resolve_device(device)
    domain, task_name = task.rsplit('_', 1)
    env = envs.load(domain, task_name, device=dev)
    plan_dim = int(env.get_goal_weights().shape[0])
    model = models.MLPDynamics(plan_dim, env.action_dim, hidden_units=50)
    with tempfile.TemporaryDirectory() as base:
        agent = agents.GoalStateAgent(
            environment=env, planner=planners.CEMPlanner, model=model,
            horizon=H, optimizer=T.adam(0.01), rollout_length=steps,
            num_rollouts_per_iteration=B, num_train_iterations=1,
            writer=None, base_path=base, seed=0,
            planner_kwargs=dict(num_candidates=K,
                                num_elites=max(K // 10, 1),
                                num_iterations=cem_iters))
    goal = env.set_goal(torch.Generator().manual_seed(3))
    collect = agent._policy_collect(B)
    collect(agent.params, None, goal, torch.Generator().manual_seed(4))
    best = math.inf
    for r in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        collect(agent.params, None, goal,
                torch.Generator().manual_seed(5 + r))
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return {
        'metric': (f'agent-path env-steps/s (GoalStateAgent batched-CEM '
                   f'{K}x{H}x{cem_iters} in featured-state space, '
                   f'{B} envs) [{task}]'),
        'value': round(B * steps / best, 1),
        'unit': 'env-steps/s',
    }


def _probe_dims(task: str):
    """(model, obs_dim, n_substeps, constraint rows) of ``task``, on the
    CPU without a reset: the observation's width at qpos0 and the rows
    ``physics.solver.assemble`` gives at qpos 0 (every candidate contact,
    as the JAX bench's trace-only probe counts them)."""
    from .physics import collision, smooth
    from .physics import model as M
    from .physics import solver
    domain, task_name = task.rsplit('_', 1)
    env = suite.load(domain, task_name, device='cpu')
    m = env.model
    obs_dim = suite.flatten_observation(
        env._observe(m, M.make_state(m), ())).shape[1]
    meta = smooth.tree_meta(m)
    qpos = torch.zeros((1, m.nq), dtype=m.dtype)
    qvel = torch.zeros((1, m.nv), dtype=m.dtype)
    (_, xquat, _, geom_xpos, geom_xmat, _, xanchor,
     xaxis) = smooth.kinematics(m, qpos, meta)
    cdof = smooth.motion_subspace(m, xquat, xanchor, xaxis, meta)
    pairs = collision.candidate_pairs(
        m, include_geom_geom=m.opt.enable_geom_geom_contacts)
    contact = (collision.detect(m, geom_xpos, geom_xmat, pairs) if pairs
               else None)
    cs = solver.assemble(m, meta, qpos, qvel, cdof, contact)
    nr = 0 if cs is None else cs.J.shape[1]
    return m, obs_dim, env._n_sub_steps, nr


def analytic_flops(task: str, B: int, K: int, H: int, cem_iters: int,
                   model_kind: str = 'mlp', hidden: int = 50):
    """Analytic FLOP counts per control step of the plan and physics
    phases, term for term the JAX bench's ``analytic_flops``: the plan's
    MLP products (B cem_iters K H forwards; an ensemble costs the same, one
    member a candidate), and per env and substep the physics' smooth
    dynamics estimate, the two Cholesky factors, the triangular solves and
    the constraint solve at the APGD iteration cap in the regime the JAX
    package picks (``physics.solver``'s ``MAX_NR`` / ``factored_fits``),
    so the physics count is an upper bound."""
    from .physics import solver
    m, obs_dim, nsub, nr = _probe_dims(task)
    act_dim, nv = m.nu, m.nv

    mlp = 2 * ((obs_dim + act_dim) * hidden + hidden * hidden
               + hidden * obs_dim)                     # MACs*2 per forward
    plan_flops = B * cem_iters * K * H * mlp

    iters = 2 * m.opt.solver_iterations                # solve_apgd cap
    power = 8                                          # warm-start iters
    smooth_est = m.nbody * 500 + nv * nv * 20          # FK / CRBA
    chol = 2 * (2.0 / 3.0) * nv ** 3                   # qM and M+hB
    tri = 6 * 2 * nv * nv                              # back-substitutions
    if nr:
        minv_jt = 2 * nv * nv * nr                     # cho_solve(J')
        if nr > solver.MAX_NR and solver.factored_fits(nr, nv):
            matvec = 2 * (2 * nr * nv + nv * nv)       # J(Minv(J'y))+Rs*y
            build = 2 * nv * nv * nv                   # Minv = solve(I)
        else:
            matvec = 2 * nr * nr                       # resident Ad @ y
            build = 2 * nv * nr * nr                   # A = J @ MinvJT
        solve_flops = (minv_jt + build + (iters + power) * matvec
                       + 2 * nr * nv)                  # J' f back-map
    else:
        solve_flops = 0
    physics_flops = B * nsub * (smooth_est + chol + tri + solve_flops)
    return {
        'plan_flops_per_ctrl_step': plan_flops,
        'physics_flops_per_ctrl_step': physics_flops,
        'nr': nr, 'nv': nv, 'n_substeps': nsub,
        'obs_dim': obs_dim, 'act_dim': act_dim,
    }


def mfu_report(fl, t_plan_s, t_phys_s, compute_dtype=None):
    """Roofline shares from analytic FLOPs and measured phase seconds: the
    plan against the tensor-core peak of the precision it runs (TF32 for
    float32, whose 3xTF32 split counts one pass of useful FLOP; BF16 for
    bf16), the physics against the FP32 peak; each with the achieved
    TFLOP/s."""
    out = {}
    if t_plan_s and t_plan_s > 0:
        tf = fl['plan_flops_per_ctrl_step'] / t_plan_s
        peak, tag = ((PEAK_BF16_FLOPS, 'bf16peak')
                     if compute_dtype == torch.bfloat16
                     else (PEAK_TF32_FLOPS, 'tf32peak'))
        out['plan_tflops'] = round(tf / 1e12, 2)
        out[f'plan_mfu_pct_{tag}'] = round(100 * tf / peak, 2)
    if t_phys_s and t_phys_s > 0:
        tf = fl['physics_flops_per_ctrl_step'] / t_phys_s
        out['physics_tflops_upper'] = round(tf / 1e12, 2)
        out['physics_mfu_pct_f32peak'] = round(100 * tf / PEAK_FP32_FLOPS, 2)
    return out


def phase_breakdown(task: str, B: int, K: int, H: int, cem_iters: int,
                    sampler: str = 'triangular', compute_dtype=None,
                    device=None):
    """Time the plan (one ``cem_batched`` call through the bench's route)
    and physics (one control step of zero actions) phases apart, each as
    ``chain`` = 10 back-to-back calls between two synchronizes divided by
    ``chain``, best of 5 after a warm-up (JAX
    ``bench.py:phase_breakdown``). Returns the JAX bench's record."""
    chain, repeats = 10, 5
    dev = resolve_device(device)
    env, state0, params, plan_batch = _planner(
        task, B, K, H, sampler, dev, 'mlp', 5, None, compute_dtype)
    obs = _observe(env, state0)
    acts = torch.zeros((B, env.model.nu), device=dev)
    gen = torch.Generator().manual_seed(2)

    def timed(fn):
        """Seconds of one of ``chain`` calls chained by ``fn``."""
        fn()
        best = math.inf
        for _ in range(repeats):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best / chain

    def plans():
        for _ in range(chain):
            plan_batch(params, obs, torch.randint(
                0, 2 ** 31 - 1, (cem_iters,), generator=gen).tolist())

    def physics():
        s = state0
        for _ in range(chain):
            s, _ = env.step(s, acts)
    t_plan, t_phys = timed(plans), timed(physics)
    fl = analytic_flops(task, B, K, H, cem_iters)
    return {
        'metric': f'phase breakdown ({task}, {B} envs, CEM {K}x{H}'
                  f'x{cem_iters}, sampler={sampler})',
        'plan_ms': round(t_plan * 1e3, 2),
        'plan_ms_per_cem_iter': round(t_plan * 1e3 / cem_iters, 2),
        'physics_ms_per_control_step': round(t_phys * 1e3, 2),
        'implied_env_steps_per_s': round(B / (t_plan + t_phys), 1),
        **mfu_report(fl, t_plan, t_phys, compute_dtype),
        'mfu_note': 'physics FLOPs counted at the APGD iteration cap '
                    '(early exit stops sooner): physics_* are upper '
                    'bounds; plan_* are exact matmul counts',
    }


def _selfcheck_inputs(task: str, dev, n: Optional[int] = None):
    """The JAX bench's selfcheck setup at B 4, H 8: a 50-hidden MLP (or an
    n-member ensemble) from seed 1 over the task's observation, goal 0,
    unit weights, start states from seed 2, mean 0, std 0.5."""
    m, obs_dim, _, _ = _probe_dims(task)
    model = models.MLPDynamics(obs_dim, m.nu, hidden_units=50)
    if n is not None:
        model = models.EnsembleDynamics(model, n)
    params = model.init(torch.Generator().manual_seed(1), device=dev)
    B, H = 4, 8
    s0 = torch.randn((B, obs_dim), generator=torch.Generator().manual_seed(
        2)).to(dev)
    goal, weights = (torch.zeros(obs_dim, device=dev),
                     torch.ones(obs_dim, device=dev))
    mean = torch.zeros((B, H, m.nu), device=dev)
    return params, s0, mean, mean + 0.5, goal, weights


def _assert_costs(costs, ref, compute_dtype, what):
    # the bf16 kernels roll the MLP in bf16 while the reference stays
    # float32: the comparison bounds accumulated rounding (JAX's rule)
    rtol, atol = ((5e-2, 5e-1) if compute_dtype is not None
                  else (1e-4, 1e-4))
    np.testing.assert_allclose(costs.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol,
                               err_msg=f'{what} diverged from the plain '
                                       'rollout cost of its actions')
    return float((costs - ref).abs().max())


def selfcheck(task: str, sampler: str = 'normal', compute_dtype=None,
              device=None) -> float:
    """The sampler kernel's costs against ``mlp_rollout_costs_reference``
    (float32) on the kernel's own actions at B 4, K 128, H 8 (JAX
    ``bench.py:selfcheck``): rtol = atol = 1e-4, bf16 rtol 5e-2 / atol
    5e-1. Raises on a mismatch; returns the largest difference."""
    dev = resolve_device(device)
    params, s0, mean, std, goal, weights = _selfcheck_inputs(task, dev)
    K = 128
    costs, actions = mlp_sample_rollout_costs(
        params, 7, s0, mean, std, goal, weights, num_candidates=K,
        sampler=sampler, compute_dtype=compute_dtype)
    B, H, ad, _ = actions.shape
    flat = actions.float().permute(1, 0, 3, 2).reshape(H, B * K, ad)
    s0f = s0[:, None].expand(B, K, s0.shape[-1]).reshape(B * K, -1)
    ref = mlp_rollout_costs_reference(params, s0f, flat, goal,
                                      weights).reshape(B, K)
    err = _assert_costs(costs, ref, compute_dtype, 'the sampler kernel')
    print(f'# selfcheck: sampler kernel vs plain rollout cost OK '
          f'(max|d|={err:.2e})', file=sys.stderr)
    return err


def selfcheck_ensemble(task: str, n: int = 5, sampler: str = 'normal',
                       compute_dtype=None, device=None) -> float:
    """The ensemble sampler kernel: candidate k costed by member k % n on
    the kernel's own actions (B 4, K 10 n, H 8; JAX
    ``bench.py:selfcheck_ensemble``), at the tolerances of ``selfcheck``."""
    dev = resolve_device(device)
    params, s0, mean, std, goal, weights = _selfcheck_inputs(task, dev, n)
    K = 10 * n
    costs, actions = mlp_sample_rollout_costs_ensemble(
        params, 7, s0, mean, std, goal, weights, num_candidates=K,
        n_members=n, sampler=sampler, compute_dtype=compute_dtype)
    B, H, ad, _ = actions.shape
    flat = actions.float().permute(1, 0, 3, 2).reshape(H, B * K, ad)
    s0f = s0[:, None].expand(B, K, s0.shape[-1]).reshape(B * K, -1)
    refs = torch.stack([mlp_rollout_costs_reference(
        {l: {k: v[i] for k, v in p.items()} for l, p in params.items()},
        s0f, flat, goal, weights).reshape(B, K) for i in range(n)])
    ref = refs[torch.arange(K) % n, :, torch.arange(K)].T
    err = _assert_costs(costs, ref, compute_dtype,
                        'the ensemble sampler kernel')
    print('# selfcheck: ensemble sampler kernel (member k % n) vs plain '
          f'rollout cost OK (max|d|={err:.2e})', file=sys.stderr)
    return err


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m mujoco_mbrl_tpu_torch.bench',
        description='env-steps/s of the MPC control step (or the agent '
                    'collector, the full MBRL iteration, the phase split) '
                    'on the card; prints one JSON line last')
    p.add_argument('--config', default=None, choices=sorted(CONFIGS),
                   help='milestone preset; sets task/envs/candidates/'
                        'horizon (+model/full-loop where the milestone '
                        'names them). Explicit flags override.')
    p.add_argument('--task', default='walker_walk')
    p.add_argument('--no-selfcheck', action='store_true',
                   help='skip the kernel-vs-plain cost check')
    p.add_argument('--envs', type=int, default=1024)
    p.add_argument('--candidates', type=int, default=1000)
    p.add_argument('--horizon', type=int, default=30)
    p.add_argument('--cem_iters', type=int, default=3,
                   help='CEM refinement iterations')
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--sampler', default='triangular',
                   choices=('normal', 'triangular', 'spline4'),
                   help='candidate sampler in the kernel: triangular '
                        '(Irwin-Hall 2, unit variance), normal '
                        '(Box-Muller) or spline4 (iCEM-style knots every 4 '
                        'steps)')
    p.add_argument('--group', type=int, default=None,
                   help="envs per program of the JAX package's TPU kernel: "
                        'a TPU layout knob, validated as there but '
                        'changing no tiling here')
    p.add_argument('--unroll', type=int, default=1,
                   help="horizon-loop unroll of the JAX package's TPU "
                        'kernel (1 or the full horizon): a TPU layout '
                        'knob, validated as there but changing nothing '
                        'here')
    p.add_argument('--dtype', default='f32', choices=('f32', 'bf16'),
                   help='sampler MLP compute dtype: bf16 runs the '
                        'candidate rollouts on the bf16 tensor cores '
                        '(costs accumulate in float32)')
    p.add_argument('--repeats', type=int, default=3)
    p.add_argument('--model', default='mlp', choices=('mlp', 'ensemble'),
                   help="'ensemble': 5-member ensemble planned with "
                        'TS-infinity member propagation')
    p.add_argument('--n_ensemble', type=int, default=5)
    p.add_argument('--agent-loop', action='store_true', dest='agent_loop',
                   help="time GoalStateAgent's batched-CEM collector "
                        '(plans in the featured state with the goal '
                        'weights)')
    p.add_argument('--full-loop', action='store_true', dest='full_loop',
                   help='time the complete collect -> replay add -> fit '
                        'iteration')
    p.add_argument('--train_epochs', type=int, default=50,
                   help='model-fit epochs per full-loop iteration')
    p.add_argument('--train_batch', type=int, default=512)
    p.add_argument('--cpu', action='store_true',
                   help='run the plain versions on the CPU')
    p.add_argument('--phases', action='store_true',
                   help='time plan and physics apart and print the '
                        'per-phase JSON line instead')
    p.add_argument('--device-timeout', type=float, default=240.0,
                   help='seconds to wait for the first CUDA call before '
                        'printing an error JSON line and exiting 3')
    return p


def _first_cuda_call(args) -> torch.device:
    """The card, behind a watchdog: if the first CUDA call does not return
    within ``--device-timeout`` seconds, print the JAX bench's error line
    and exit 3. Raises when no CUDA device is present."""
    def no_device():
        print(json.dumps({
            'metric': f'env-steps/s/chip ({args.task}) — DEVICE INIT '
                      'TIMEOUT: CUDA device unreachable',
            'value': 0.0, 'unit': 'env-steps/s',
            'error': f'device init exceeded {args.device_timeout}s',
        }), flush=True)
        os._exit(3)

    watchdog = threading.Timer(args.device_timeout, no_device)
    watchdog.daemon = True
    watchdog.start()
    try:
        dev = resolve_device('cuda')
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    finally:
        watchdog.cancel()
    return dev


def main(argv=None) -> int:
    """The bench's command line (JAX ``bench.py:main``); prints the JSON
    line last and returns the exit code."""
    p = _parser()
    args = p.parse_args(argv)
    if args.config:
        # preset first, explicit flags win: re-parse with preset defaults
        p.set_defaults(**CONFIGS[args.config])
        args = p.parse_args(argv)
    if args.unroll not in (1, args.horizon):
        p.error(f'--unroll must be 1 or the full horizon '
                f'({args.horizon}): Pallas fori_loop supports no '
                'partial unroll')
    if args.group is not None and args.group > 1:
        if args.sampler == 'spline4':
            p.error('--group > 1 is not supported with --sampler spline4')
        if args.model == 'ensemble':
            p.error('--group > 1 is not supported with --model ensemble '
                    '(the ensemble kernel blocks lanes by member)')
        if args.envs % args.group != 0:
            p.error(f'--envs {args.envs} must be divisible by '
                    f'--group {args.group}')

    if args.cpu:
        dev = torch.device('cpu')
    else:
        try:
            dev = _first_cuda_call(args)
        except RuntimeError as e:
            print(f'bench: {e}', file=sys.stderr)
            return 1
    compute_dtype = torch.bfloat16 if args.dtype == 'bf16' else None

    if args.phases:
        rec = phase_breakdown(args.task, args.envs, args.candidates,
                              args.horizon, args.cem_iters, args.sampler,
                              compute_dtype, dev)
        print(json.dumps(rec))
        return 0

    if not args.cpu and not args.no_selfcheck:
        if args.model == 'ensemble':
            selfcheck_ensemble(args.task, args.n_ensemble, args.sampler,
                               compute_dtype, dev)
        else:
            selfcheck(args.task, args.sampler, compute_dtype, dev)

    if args.agent_loop:
        print(json.dumps(agent_loop_bench(
            args.task, args.envs, args.candidates, args.horizon,
            args.cem_iters, args.steps, args.repeats, dev)))
        return 0

    if args.full_loop:
        out = full_loop_bench(
            args.task, args.envs, args.candidates, args.horizon,
            args.cem_iters, args.steps, args.repeats, args.sampler, dev,
            args.train_epochs, args.train_batch, compute_dtype)
        print(json.dumps({
            'metric': (f'full MBRL-loop env-steps/s (collect {args.envs}x'
                       f'{args.steps} with CEM {args.candidates}x'
                       f'{args.horizon}x{args.cem_iters} MPC + replay add '
                       f'+ fit {args.train_epochs} epochs '
                       f'bs{args.train_batch}) [{args.task}]'),
            'value': round(out['env_steps_per_s'], 1),
            'unit': 'env-steps/s',
            'iteration_s': round(out['iteration_s'], 3),
            'final_train_loss': round(out['final_loss'], 5),
        }))
        return 0

    run, (params, state0, gen) = build_bench(
        args.task, args.envs, args.candidates, args.horizon, args.cem_iters,
        args.steps, args.sampler, dev, args.model, args.n_ensemble,
        compute_dtype=compute_dtype)
    run(params, state0, gen)                           # warm-up
    best = math.inf
    for _ in range(args.repeats):
        _sync(dev)
        t0 = time.perf_counter()
        run(params, state0, gen)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    env_steps_per_s = args.envs * args.steps / best
    model_tag = (f', {args.n_ensemble}-member ensemble TS-inf'
                 if args.model == 'ensemble' else '')
    # roofline: analytic FLOPs over the measured wall time against the
    # bf16 tensor-core peak (the per-phase shares are --phases' keys)
    fl = analytic_flops(args.task, args.envs, args.candidates, args.horizon,
                        args.cem_iters, args.model)
    tflops = ((fl['plan_flops_per_ctrl_step']
               + fl['physics_flops_per_ctrl_step']) * args.steps / best
              / 1e12)
    print(json.dumps({
        'metric': (f'env-steps/s/chip with CEM '
                   f'{args.candidates}x{args.horizon} MPC planning '
                   f'({args.task}, {args.envs} envs{model_tag})'),
        'value': round(env_steps_per_s, 1),
        'unit': 'env-steps/s',
        'achieved_tflops_upper': round(tflops, 2),
        'mfu_pct_bf16peak': round(100 * tflops * 1e12 / PEAK_BF16_FLOPS, 2),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
