"""The per-env policy and the agents around it, port vs JAX.

* ``MPCPolicy`` with random shooting over five control steps, t = 0, 1,
  2, 0, 1, at B = 3 against JAX's one-env policy under ``vmap`` on JAX's
  own draws (the t == 0 fallback and the candidates): each step's actions
  and warm-started plan at rtol 1e-5; the warm start is the previous plan
  and a new episode (t == 0) drops it.
* ``GoalStateAgent.get_action`` with CEM on point_mass, two calls (t = 0
  from no carry, t = 1 from the first call's carry) against JAX's on its
  normals (rtol 1e-5); on a state-space agent (walker) it fails on both
  sides, since neither passes the policy a state.
* The batched CEM's routes as JAX routes them: a linear model, an MLP with
  output noise and an ensemble whose size does not divide the candidate
  count plan through ``cem_batched``'s model / cost scan (no sampler, no
  given-action kernel), held against JAX's batched policy on its normals
  (rtol 1e-5); a plain MLP and a dividing ensemble take the samplers.
* Tiny agents end to end on the CPU: ``GoalStateAgent`` with random
  shooting and gradient descent, ``RewardAgent`` with CEM over the reward
  model; and where JAX fails, the port fails at the same call: iLQR's
  planner, an RNN model and a reward model in a goal-state agent, an MLP
  in a reward agent, an ensemble planned per env on a single state whose
  dims its size divides (the policy call on both sides, the agent loop
  on the port's).
* ``get_rollouts`` from given initial states with a per-env policy on
  reacher against JAX's (atol 1e-4 over 3 control steps), the reacher's
  biased-reward rollouts (each arm starts on its target, on both sides),
  the walker's and cheetah's ``sample_state`` (their boxes and structure
  on both sides), and every ``experiment`` enum value constructing.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mujoco_mbrl_tpu import agents as jagents
from mujoco_mbrl_tpu import data as jdata
from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu import experiment as jexperiment
from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import planners as jplanners
from mujoco_mbrl_tpu_torch import (agents, convert, data, envs, experiment,
                                   models, planners)
from mujoco_mbrl_tpu_torch.models import train as Mt
from mujoco_mbrl_tpu_torch.planners import shooting
from mujoco_mbrl_tpu_torch.utils import MetricsWriter

B, H, SD, AD, K, HID = 3, 4, 4, 2, 10, 16


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def jsample(key, shape):
    return jax.random.uniform(key, tuple(shape) + (AD,), minval=-1.0,
                              maxval=1.0)


@pytest.fixture(scope='module')
def mlp():
    jm = jmodels.MLPDynamics(SD, AD, hidden_units=HID)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    goal = rng.normal(size=SD).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, SD).astype(np.float32)
    return dict(jm=jm, jp=jp, tm=models.MLPDynamics(SD, AD, hidden_units=HID),
                tp=convert.mlp_params(jax.tree_util.tree_map(np.asarray, jp)),
                goal=goal, weights=weights)


def test_mpc_policy_warm_start_and_fallback_match_jax(mlp):
    jcost = lambda s, a: (jmodels.smooth_abs_loss(s, mlp['goal'],
                                                  mlp['weights'])
                          + jmodels.cosh_loss(a))
    tcost = lambda s, a: (models.smooth_abs_loss(
        s, torch.as_tensor(mlp['goal']), torch.as_tensor(mlp['weights']))
        + models.cosh_loss(a))
    jpol = jagents.MPCPolicy(
        lambda s, a: mlp['jm'].forward(mlp['jp'], s, a), jcost,
        jplanners.RandomShootingPlanner, jsample, H, AD, SD,
        planner_kwargs=dict(num_trajectories=K))
    fed, warm_starts = {}, []

    class Spy(planners.RandomShootingPlanner):
        @classmethod
        def plan(cls, *args, initial_trajectory=None, **kwargs):
            warm_starts.append(initial_trajectory.actions)
            return super().plan(*args, initial_trajectory=initial_trajectory,
                                **kwargs)
    tpol = agents.MPCPolicy(
        lambda s, a: mlp['tm'].forward(mlp['tp'], s, a), tcost, Spy,
        lambda g, shape: fed['fallback' if len(shape) == 2 else 'cand'],
        H, AD, SD, planner_kwargs=dict(num_trajectories=K))
    jcarry = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jpol.init_carry())
    tcarry = tpol.init_carry()
    rng = np.random.RandomState(4)
    step = jax.jit(jax.vmap(jpol, in_axes=(0, None, None, 0, 0)))
    for i, t in enumerate((0, 1, 2, 0, 1)):
        obs = rng.normal(size=(B, SD)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(10 + i), B)
        kf, kp = jax.vmap(jax.random.split)(keys).transpose(1, 0, 2)
        fed['fallback'] = torch.as_tensor(np.asarray(
            jax.vmap(lambda k: jsample(k, (H,)))(kf)))
        fed['cand'] = torch.as_tensor(np.asarray(jax.vmap(
            lambda k: jsample(jax.random.split(k)[0], (H, K)))(kp)))
        ja, jcarry = step(keys, jnp.asarray(t), None, obs, jcarry)
        last = tcarry[1]
        ta, tcarry = tpol(_gen(i), t, None, torch.as_tensor(obs), tcarry)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-6, err_msg=f'step {i}')
        np.testing.assert_allclose(tcarry[1].actions.numpy(),
                                   np.asarray(jcarry[1].actions),
                                   rtol=1e-5, atol=1e-6)
        # the warm start: the previous plan, or the fallback draw at t == 0
        assert torch.equal(warm_starts[-1], fed['fallback'] if t == 0
                           else last.actions)
        assert tcarry[0] is True


def _buffers(obs_dim, state_dim, rng):
    """The same 3 synthetic rollouts of 5 steps in a JAX and a port ring."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    rolls = jdata.Rollouts(states=f(3, 6, state_dim), observations=f(
        3, 6, obs_dim) * 1.5, actions=np.clip(f(3, 5, AD), -1, 1),
        rewards=f(3, 5))
    jbuf = jdata.add_rollouts(jdata.init_replay(4, 5, state_dim, obs_dim,
                                                AD),
                              jax.tree_util.tree_map(jnp.asarray, rolls))
    return jbuf, convert.replay_buffer(jbuf)


@functools.lru_cache(maxsize=None)
def _envs(domain, task):
    """The JAX and the port wrapper (loaded once a module: the JAX
    wrapper's observation spec runs a reset)."""
    return jenvs.load(domain, task), envs.load(domain, task, device='cpu')


def _agents(domain, task, model_pair, planner_pair, agent='gs', K_=K,
            iters=2, extra=None):
    """A JAX agent and a port agent on the same carried-over params and
    replay, with a fixed goal."""
    jenv, tenv = _envs(domain, task)
    jm, tm = model_pair
    jbuf, tbuf = _buffers(jenv.observation_dim, jenv.state_dim,
                          np.random.RandomState(5))
    kw = lambda: dict(horizon=H, rollout_length=5, num_rollouts_per_iteration=B,
              num_train_iterations=1, writer=None, base_path='unused',
              seed=0, train_epochs=1, train_batch_size=4,
              num_initial_rollouts=2,
              planner_kwargs=dict(num_candidates=K_, num_elites=3,
                                  num_iterations=iters, **(extra or {})))
    if agent == 'gs':
        ja = jagents.GoalStateAgent(environment=jenv, planner=planner_pair[0],
                                    model=jm, optimizer=optax.adam(0.01),
                                    dataset=jbuf, **kw())
        ta = agents.GoalStateAgent(environment=tenv, planner=planner_pair[1],
                                   model=tm, optimizer=Mt.adam(0.01),
                                   dataset=tbuf, **kw())
    else:
        ja = jagents.RewardAgent(environment=jenv, planner=planner_pair[0],
                                 model=jm, optimizer=optax.adam(0.01),
                                 dataset=jbuf, **kw())
        ta = agents.RewardAgent(environment=tenv, planner=planner_pair[1],
                                model=tm, optimizer=Mt.adam(0.01),
                                dataset=tbuf, **kw())
    with torch.no_grad():
        for dst, src in zip(Mt.param_leaves(ta.params), Mt.param_leaves(
                jax.tree_util.tree_map(lambda x: torch.as_tensor(
                    np.asarray(x)), ja.params))):
            dst.copy_(src)
    if agent == 'gs':
        ja.training_goal_state = jenv.set_goal(jax.random.PRNGKey(1))
        ta.training_goal_state = torch.as_tensor(np.asarray(
            ja.training_goal_state))
    return ja, ta


def test_get_action_with_cem_matches_jax():
    ja, ta = _agents('point_mass', 'easy',
                     (jmodels.MLPDynamics(SD, AD, hidden_units=HID),
                      models.MLPDynamics(SD, AD, hidden_units=HID)),
                     (jplanners.CEMPlanner, planners.CEMPlanner))
    obs = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
    jcarry = tcarry = None
    for t, seed in ((0, 3), (1, 4)):
        key = jax.random.PRNGKey(seed)
        kp = jax.random.split(key)[1]
        ta.planner_kwargs['normals'] = torch.as_tensor(np.asarray(
            jnp.stack([jax.random.normal(ik, (H, K, AD))
                       for ik in jax.random.split(kp, 2)])))[:, None]
        jact, jcarry = jax.jit(ja.get_action)(key, jnp.asarray(obs),
                                              jcarry, jnp.asarray(t))
        tact, tcarry = ta.get_action(_gen(), torch.as_tensor(obs), tcarry, t)
        np.testing.assert_allclose(tact.numpy(), np.asarray(jact),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tcarry[1].actions[0].numpy(),
                                   np.asarray(jcarry[1].actions), rtol=1e-5,
                                   atol=1e-6)


def test_get_action_of_a_state_space_agent_fails_on_both_sides(mlp):
    """JAX's get_action calls its policy with no state (agents/mpc.py:
    525-531); a policy planning on states then plans from None. The JAX
    policy is called as get_action calls it; the port's through a walker
    agent's own get_action."""
    jpol = jagents.MPCPolicy(
        lambda s, a: mlp['jm'].forward(mlp['jp'], s, a),
        lambda s, a: jmodels.cosh_loss(a), jplanners.CEMPlanner, jsample, H,
        AD, SD, planner_kwargs=dict(num_candidates=K, num_elites=3),
        plan_on_observations=False)
    with pytest.raises(AttributeError, match="'NoneType'"):
        jpol(jax.random.PRNGKey(0), jnp.asarray(0), None, jnp.zeros(SD),
             jpol.init_carry())
    env = envs.load('walker', 'walk', device='cpu')
    agent = _tiny(env, models.MLPDynamics(20, 6, hidden_units=8),
                  planners.CEMPlanner)
    assert agent.obs_only is False
    agent.training_goal_state = env.set_goal()
    with pytest.raises(AttributeError, match="'NoneType'"):
        agent.get_action(_gen(), torch.zeros(env.observation_dim))


@pytest.mark.parametrize('kind', ['lin', 'noise', 'ens'])
def test_batched_scan_routes_match_jax(kind, monkeypatch):
    if kind == 'lin':
        pair = (jmodels.LinearDynamics(SD, AD), models.LinearDynamics(SD, AD))
    elif kind == 'noise':
        pair = (jmodels.MLPDynamics(SD, AD, hidden_units=HID, noise=0.1),
                models.MLPDynamics(SD, AD, hidden_units=HID, noise=0.1))
    else:
        pair = (jmodels.EnsembleDynamics(jmodels.MLPDynamics(
            SD, AD, hidden_units=HID), 3), models.EnsembleDynamics(
                models.MLPDynamics(SD, AD, hidden_units=HID), 3))
    ja, ta = _agents('point_mass', 'easy', pair,
                     (jplanners.CEMPlanner, planners.CEMPlanner))
    jnorm = ja._normalizers()
    jpol = ja._make_batched_policy(ja.params, jnorm, ja.training_goal_state,
                                   B)
    if kind == 'ens':
        with pytest.warns(RuntimeWarning, match='not divisible'):
            tpol = ta._make_batched_policy(ta.params, ta._normalizers(),
                                           ta.training_goal_state)
    else:
        tpol = ta._make_batched_policy(ta.params, ta._normalizers(),
                                       ta.training_goal_state)
    assert tpol.sample_costs_builder is None and tpol.rollout_costs_fn is None
    obs = np.random.RandomState(6).normal(size=(B, SD)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    eps = [torch.as_tensor(np.asarray(jax.random.normal(
        ik, (H, AD, B, K), jnp.float32)))
        for ik in jax.random.split(key, 2)]
    monkeypatch.setattr(shooting, '_normals', lambda *a: eps.pop(0))
    jact, jcarry = jpol(key, jnp.asarray(0), obs, obs, jpol.init_carry())
    tact, tcarry = tpol(_gen(), 0, torch.as_tensor(obs),
                        torch.as_tensor(obs), tpol.init_carry())
    assert not eps
    # the batched refit's elite std is sqrt(sum2 / E - mean^2) in float32
    # in both packages: where the elites coincide (all clipped to a bound)
    # the difference is rounding, ~1e-7, and its square root, ~3e-4,
    # scales the next iteration's normals: atol 5e-4
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=1e-5,
                               atol=5e-4)
    np.testing.assert_allclose(tcarry[1].numpy(), np.asarray(jcarry[1]),
                               rtol=1e-5, atol=5e-4)


def test_plain_mlp_and_dividing_ensemble_take_the_samplers():
    env = _envs('point_mass', 'easy')[1]
    for model in (models.MLPDynamics(SD, AD, hidden_units=HID),
                  models.EnsembleDynamics(models.MLPDynamics(
                      SD, AD, hidden_units=HID), 5)):
        agent = _tiny(env, model, planners.CEMPlanner)
        pol = agent._make_batched_policy(agent.params, agent._normalizers(),
                                         env.set_goal(_gen()))
        assert pol.sample_costs_builder is not None


def _tiny(env, model, planner, agent_cls=agents.GoalStateAgent, tmp=None):
    kw = dict(environment=env, planner=planner, model=model, horizon=H,
              optimizer=Mt.adam(0.01), rollout_length=4,
              num_rollouts_per_iteration=2, num_train_iterations=1,
              writer=None if tmp is None else MetricsWriter(str(tmp)),
              base_path='unused',
              dataset=data.init_replay(8, 4, env.state_dim,
                                       env.observation_dim, env.action_dim,
                                       device='cpu'),
              seed=0, train_epochs=1, train_batch_size=4,
              num_initial_rollouts=2,
              planner_kwargs=dict(num_trajectories=K, num_candidates=K,
                                  num_elites=3, num_iterations=2))
    return agent_cls(**kw)


@pytest.mark.parametrize('planner', ['rs', 'grad'])
def test_goal_state_agent_trains_per_env(tmp_path, planner):
    env = _envs('point_mass', 'easy')[1]
    agent = _tiny(env, models.MLPDynamics(SD, AD, hidden_units=HID),
                  experiment.Planner(planner).construct(), tmp=tmp_path)
    agent.train()
    assert agent.dataset.filled == 4 and agent.train_iterations == 1
    acts = agent.dataset.actions[2:4]
    assert bool(torch.isfinite(acts).all())
    if planner == 'rs':          # candidates are sample_action draws
        assert float(acts.abs().max()) <= 1.0
    tags = (tmp_path / 'metrics.jsonl').read_text()
    assert 'AvgRolloutRewards/policy' in tags


def test_reward_agent_trains_and_acts(tmp_path):
    env = _envs('point_mass', 'easy')[1]
    agent = _tiny(env, models.RewardDynamics(SD, AD, hidden_units=HID),
                  planners.CEMPlanner, agents.RewardAgent, tmp=tmp_path)
    agent.train()
    assert agent.dataset.filled == 4
    act, carry = agent.get_action(_gen(), torch.zeros(SD))
    assert act.shape == (AD,) and carry[0] is True
    assert float(act.abs().max()) <= 1.0


def test_reward_agent_cost_matches_jax():
    """The per-env CEM of a RewardAgent (cost: minus the predicted reward
    of (s_t, a_t)) against JAX's get_action on its normals."""
    ja, ta = _agents('point_mass', 'easy',
                     (jmodels.RewardDynamics(SD, AD, hidden_units=HID),
                      models.RewardDynamics(SD, AD, hidden_units=HID)),
                     (jplanners.CEMPlanner, planners.CEMPlanner), agent='rw')
    key = jax.random.PRNGKey(2)
    kp = jax.random.split(key)[1]
    ta.planner_kwargs['normals'] = torch.as_tensor(np.asarray(jnp.stack([
        jax.random.normal(ik, (H, K, AD))
        for ik in jax.random.split(kp, 2)])))[:, None]
    obs = np.array([0.2, 0.1, -0.3, 0.0], np.float32)
    jact, _ = ja.get_action(key, jnp.asarray(obs))
    tact, _ = ta.get_action(_gen(), torch.as_tensor(obs))
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=1e-5,
                               atol=1e-6)


def _jax_policy_call(ja, obs):
    pol = ja._make_policy(ja.params, ja._normalizers(),
                          ja.training_goal_state)
    return pol(jax.random.PRNGKey(0), jnp.asarray(0), None, jnp.asarray(obs),
               pol.init_carry())


def _port_policy_call(ta, obs):
    pol = ta._make_policy(ta.params, ta._normalizers(),
                          ta.training_goal_state)
    return pol(_gen(), 0, None, torch.as_tensor(obs)[None], pol.init_carry())


@pytest.mark.parametrize('case', ['rnn', 'rw_model', 'ens_single_state'])
def test_goal_state_agent_failures_match_jax(case):
    """Each fails in JAX's policy call and in the port's, with the same
    error type, and the port's agent loop fails there too, after its seed
    collection and fit."""
    if case == 'rnn':
        pair = (jmodels.RNNDynamics(SD, AD, hidden_units=8),
                models.RNNDynamics(SD, AD, hidden_units=8))
        planner, err = 'rs', TypeError
    elif case == 'rw_model':
        pair = (jmodels.RewardDynamics(SD, AD, hidden_units=8),
                models.RewardDynamics(SD, AD, hidden_units=8))
        planner, err = 'rs', TypeError
    else:                    # 2 members divide point_mass's 4 plan dims
        pair = (jmodels.EnsembleDynamics(jmodels.MLPDynamics(SD, AD, 8), 2),
                models.EnsembleDynamics(models.MLPDynamics(SD, AD, 8), 2))
        planner, err = 'grad', TypeError
    ja, ta = _agents('point_mass', 'easy', pair,
                     (jexperiment.Planner(planner).construct(),
                      experiment.Planner(planner).construct()))
    obs = np.zeros(SD, np.float32)
    with pytest.raises(err):
        _jax_policy_call(ja, obs)
    with pytest.raises(err):
        _port_policy_call(ta, obs)
    env = _envs('point_mass', 'easy')[1]
    agent = _tiny(env, pair[1], ta.planner)
    with pytest.raises(err):
        agent.train()
    assert agent.dataset.filled == 2 and agent.train_iterations == 1


def test_reward_agent_on_a_plain_mlp_and_ilqr_fail_as_in_jax():
    env = _envs('point_mass', 'easy')[1]
    mlp = models.MLPDynamics(SD, AD, hidden_units=8)
    with pytest.raises(ValueError, match='too many values to unpack'):
        _tiny(env, mlp, planners.CEMPlanner, agents.RewardAgent).train()
    ja, _ = _agents('point_mass', 'easy',
                    (jmodels.MLPDynamics(SD, AD, 8), mlp),
                    (jplanners.CEMPlanner, planners.CEMPlanner), agent='rw')
    jpol = ja._make_policy(ja.params, ja._normalizers())
    with pytest.raises(ValueError, match='too many values to unpack'):
        jpol(jax.random.PRNGKey(0), jnp.asarray(0), None, jnp.zeros(SD),
             jpol.init_carry())
    agent = _tiny(env, mlp, planners.ILQRPlanner)
    with pytest.raises(AttributeError, match="no attribute 'ilqr'"):
        agent.train()
    assert agent.dataset.filled == 2


# ------------------------------------------------------------- collection
def test_get_rollouts_from_initial_states_matches_jax():
    jw = jenvs.load('reacher', 'easy')
    tw = envs.load('reacher', 'easy', device='cpu')
    rng = np.random.RandomState(7)
    init = np.stack([np.asarray(jw.sample_state(k)) for k in
                     jax.random.split(jax.random.PRNGKey(3), B)])
    goal = np.asarray(jw.set_goal(jax.random.PRNGKey(4)))
    wmat = rng.normal(size=(4, 2)).astype(np.float32)
    jpol = lambda key, t, s, o, c: (jnp.tanh(s @ wmat), c)
    tpol = lambda g, t, s, o, c: (torch.tanh(s @ torch.as_tensor(wmat)), c)
    jr = jax.jit(lambda k: jw.get_rollouts(k, B, 3, policy=jpol,
                                           goal_state=goal,
                                           initial_states=init))(
        jax.random.PRNGKey(5))
    tr = tw.get_rollouts(_gen(), B, 3, policy=tpol,
                         goal_state=torch.as_tensor(goal),
                         initial_states=torch.as_tensor(init))
    np.testing.assert_allclose(tr.states[:, 0].numpy(), init, atol=1e-6)
    for f in ('states', 'observations', 'actions', 'rewards'):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_biased_reward_rollouts_start_on_the_target():
    """Each rollout's arm starts at its goal pose with zero velocity and
    its finger on the target (to_target ~ 0, reward 1 at the start)."""
    jw = jenvs.load('reacher', 'easy')
    tw = envs.load('reacher', 'easy', device='cpu')
    jr = jax.jit(lambda k: jw.sample_rollouts_biased_rewards(k, 4, 2))(
        jax.random.PRNGKey(0))
    tr = tw.sample_rollouts_biased_rewards(_gen(), 4, 2)
    fields = ('states', 'observations', 'actions', 'rewards')
    for r in ({f: np.asarray(getattr(jr, f)) for f in fields},
              {f: getattr(tr, f).numpy() for f in fields}):
        r = type('R', (), r)
        assert r.states.shape == (4, 3, 4) and r.actions.shape == (4, 2, 2)
        assert (np.abs(r.states[:, 0, 2:]) == 0).all()
        assert (np.abs(r.states[:, 0, :2]) <= [np.pi, 2.8]).all()
        assert np.abs(r.observations[:, 0, 2:4]).max() < 1e-5
        assert (r.rewards[:, 0] > 0.5).all()


@pytest.mark.parametrize('domain', ['Walker', 'Cheetah'])
def test_sample_state_boxes_match_jax(domain):
    """Neither wrapper's sample_state reads its env but for the device, so
    both run on bare wrappers (no model compile, no settling reset)."""
    jfn = getattr(jenvs.wrappers, domain).sample_state
    js = np.stack([np.asarray(jfn(None, k)) for k in
                   jax.random.split(jax.random.PRNGKey(0), 50)])
    tw = object.__new__(getattr(envs.wrappers, domain))
    tw._env = SimpleNamespace(model=SimpleNamespace(device=torch.device(
        'cpu')))
    ts = tw.sample_state(_gen(), (400,)).numpy()
    assert js.shape[1:] == ts.shape[1:] == (18,)
    for x in (js, ts):
        if domain == 'Walker':
            lo = np.array([0, 0, -.1, -.15, -.3, -.1, -.15, -.3, -.1])
            hi = np.array([0, 0, .1, .15, 0, .1, .15, 0, .1])
            np.testing.assert_array_equal(x[:, 6], -x[:, 3])
            assert not x[:, 9:].any()
        else:
            lo = np.array([0] + [r[0] for r in tw._SAMPLE_RANGES])
            hi = np.array([0] + [r[1] for r in tw._SAMPLE_RANGES])
            assert (np.abs(x[:, 9:]) <= 3).all()
        assert ((x[:, :9] >= lo - 1e-6) & (x[:, :9] <= hi + 1e-6)).all()
    # the port's draws fill their boxes (uniform: every coordinate spans
    # most of its range over 400 draws)
    span = ts.max(0) - ts.min(0)
    width = np.concatenate([hi - lo, np.full(9, 6.0 if domain == 'Cheetah'
                                             else 0.0)])
    assert (span >= 0.9 * width - 1e-6).all()


def test_every_cli_choice_constructs():
    env = _envs('point_mass', 'easy')[1]
    for p in experiment.Planner:
        assert (p.construct().__name__
                == jexperiment.Planner(p.value).construct().__name__)
    for mo in experiment.Model:
        model = mo.construct(env)
        jmodel = jexperiment.Model(mo.value).construct(
            _envs('point_mass', 'easy')[0])
        assert type(model).__name__ == type(jmodel).__name__
        for ag in experiment.Agent:
            agent = ag.construct(
                environment=env, planner=planners.RandomShootingPlanner,
                model=mo.construct(env), horizon=H,
                optimizer=Mt.adam(0.01), rollout_length=4,
                num_rollouts_per_iteration=1, num_train_iterations=1,
                writer=None, base_path='unused', seed=0)
            assert type(agent).__name__ == {
                'gs': 'GoalStateAgent', 'rw': 'RewardAgent'}[ag.value]
    for o in experiment.Optimizer:
        assert o.construct() is not None
