"""The reacher's planner path, port against the JAX package.

* ``cem_batched``'s model / cost scan (both candidate functions None)
  against the JAX ``cem_batched`` on the same normals (the JAX draws,
  handed to the port through ``shooting._normals``), reacher widths: the
  candidates' costs (rtol 1e-5), the returned actions and, with
  ``return_states``, the states re-rolled through the model (atol 1e-5).
* The ``reacher256`` preset: ``bench.config`` gives the JAX preset,
  ``build_bench`` takes the JAX route rule (the scan below obs_dim +
  act_dim = 16, the fused sampler above it, ``fused=False`` the
  rollout-cost kernel's branch; the scan's costs and refit are the ones
  held above, its physics step is held in tests/test_torch_contact_free.py).
* ``GoalStateAgent.train()`` on reacher_easy on the CPU at a tiny size:
  it plans on the 6-dim observation and fills the replay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import planners as jplanners
from mujoco_mbrl_tpu.planners import shooting as jshooting
from mujoco_mbrl_tpu_torch import agents, bench, convert, envs, models
from mujoco_mbrl_tpu_torch import planners
from mujoco_mbrl_tpu_torch.models import train as Mt
from mujoco_mbrl_tpu_torch.planners import shooting

SD, AD = 6, 2


def _cost_fns(goal, weights):
    jcost = lambda s, a: (jmodels.smooth_abs_loss(s, jnp.asarray(goal),
                                                  jnp.asarray(weights))
                          + jmodels.cosh_loss(a))
    tcost = lambda s, a: (models.smooth_abs_loss(s, torch.as_tensor(goal),
                                                 torch.as_tensor(weights))
                          + models.cosh_loss(a))
    return jcost, tcost


def _feed_normals(monkeypatch, normals):
    """The port's per-iteration normals, in order, from `normals`."""
    it = iter(normals)
    monkeypatch.setattr(shooting, '_normals',
                        lambda seed, shape, dtype, device: torch.as_tensor(
                            np.array(next(it))).reshape(shape))


def test_cem_scan_matches_jax(monkeypatch):
    B, K, H, iters, E = 3, 40, 5, 3, 4
    jm = jmodels.MLPDynamics(SD, AD, hidden_units=50)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tp = convert.mlp_params(jp)
    tm = models.MLPDynamics(SD, AD, hidden_units=50)
    rng = np.random.RandomState(0)
    s0 = rng.normal(size=(B, SD)).astype(np.float32)
    goal = rng.normal(size=SD).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, SD).astype(np.float32)
    jcost, tcost = _cost_fns(goal, weights)
    key = jax.random.PRNGKey(4)
    normals = [jax.random.normal(k, (H, AD, B, K))
               for k in jax.random.split(key, iters)]

    # the candidate costs of the first iteration, on the same actions
    acts = np.clip(np.asarray(normals[0]), -1, 1).reshape(H, AD, B * K)
    s0f = np.repeat(s0, K, axis=0)
    jc = jshooting._rollout_costs(
        lambda s, a: jm.forward(jp, s, a), jcost, jnp.asarray(s0f),
        jnp.asarray(acts.transpose(0, 2, 1)))
    tc = shooting._rollout_costs(
        lambda s, a: tm.forward(tp, s, a), tcost, torch.as_tensor(s0f),
        torch.as_tensor(acts).transpose(1, 2))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)

    jtraj = jax.jit(lambda k: jplanners.cem_batched(
        k, jnp.asarray(s0), lambda s, a: jm.forward(jp, s, a), jcost,
        horizon=H, action_dim=AD, num_candidates=K, num_elites=E,
        num_iterations=iters, return_states=True))(key)
    _feed_normals(monkeypatch, normals)
    ttraj = planners.cem_batched(
        list(range(iters)), torch.as_tensor(s0), H, AD, num_candidates=K,
        num_elites=E, model=lambda s, a: tm.forward(tp, s, a), cost=tcost,
        return_states=True)
    assert ttraj.actions.shape == (H, B, AD)
    assert ttraj.states.shape == (H + 1, B, SD)
    np.testing.assert_allclose(ttraj.actions.numpy(),
                               np.asarray(jtraj.actions), atol=1e-5)
    np.testing.assert_allclose(ttraj.states.numpy(),
                               np.asarray(jtraj.states), atol=1e-5)
    # the refits moved the proposal away from its zero start
    assert float(ttraj.actions.abs().max()) > 0.05
    with pytest.raises(ValueError, match='model and a cost'):
        planners.cem_batched([0], torch.as_tensor(s0), H, AD,
                             num_candidates=K, num_elites=E)


def test_reacher256_preset_and_route(monkeypatch):
    cfg = bench.config('reacher256')
    assert cfg == {k: v for k, v in jbench.CONFIGS['reacher256'].items()}
    taken = []
    for name in ('_rollout_costs',):
        real = getattr(shooting, name)
        monkeypatch.setattr(shooting, name, lambda *a, _r=real, **k: (
            taken.append('scan'), _r(*a, **k))[1])
    for name in ('mlp_sample_rollout_costs', 'mlp_rollout_costs_t'):
        real = getattr(bench, name)
        monkeypatch.setattr(bench, name, lambda *a, _r=real, _n=name, **k: (
            taken.append(_n), _r(*a, **k))[1])
    for task, kw, want in (('reacher_easy', {}, 'scan'),
                           ('reacher_easy', dict(fused=True),
                            'mlp_sample_rollout_costs'),
                           ('reacher_easy', dict(fused=False),
                            'mlp_rollout_costs_t'),
                           ('point_mass_easy', {}, 'scan')):
        taken.clear()
        run, (p, s, g) = bench.build_bench(task, 2, 8, 3, 2, 1,
                                           device='cpu', **kw)
        run(p, s, g)
        assert set(taken) == {want}, (task, kw, taken)


def test_goal_state_agent_on_reacher(tmp_path):
    env = envs.load('reacher', 'easy', device='cpu')
    model = models.MLPDynamics(env.observation_dim, env.action_dim,
                               hidden_units=16)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=3, optimizer=Mt.adam(0.01), rollout_length=3,
        num_rollouts_per_iteration=3, num_train_iterations=1, writer=None,
        base_path=str(tmp_path),
        planner_kwargs=dict(num_candidates=16, num_elites=4,
                            num_iterations=2),
        train_epochs=1, train_batch_size=8, num_initial_rollouts=4, seed=0)
    assert agent.obs_only and agent.plan_dim == 6
    agent.train()
    buf = agent.dataset
    assert buf.filled == 7
    assert bool(torch.isfinite(buf.observations[:7]).all())
    # the training goal's target sits at the finger of the goal pose
    goal = agent.training_goal_state
    assert goal.shape == (6,) and float(goal[2:].abs().max()) == 0.0
