"""The agent loop, port vs JAX: wrappers, collection, GoalStateAgent, CLI.

* The walker's featured state (qpos[1:], qvel, upright, height, speed),
  goal and goal weights against ``envs/wrappers.py:537-583`` on the same
  states (atol 1e-5).
* ``collect_from`` over 3 control steps with a fixed action sequence from
  the JAX package's own reset states, against its ``get_rollouts_batched``
  (states, observations and rewards of the first step at atol 1e-4, all
  three steps at rtol 1e-4 and atol 1e-4: float32 contact drift).
* The observation key order of the two JAX collectors, established on a
  stub env with no physics: the batched collector flattens its first
  observation in the task's key order and later ones in sorted order, the
  random (per-env) collector all of them in task order. The port's
  collectors are held to the same orders.
* ``GoalStateAgent.train()`` on the CPU at a tiny size with the MLP and
  the ensemble (after ``tests/test_agents_e2e.py:114-140``): the dataset
  fill, the metric tags and a checkpoint round trip; the experiment CLI
  with ``device='cpu'``; and the choices that are not ported raise.

One JAX walker compile for the whole file (module fixture).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu_torch import (agents, convert, data, envs, experiment,
                                   models, planners)
from mujoco_mbrl_tpu_torch.models import train as Mt
from mujoco_mbrl_tpu_torch.utils import MetricsWriter

B, T, BR = 3, 3, 2
HEIGHT_TASK, HEIGHT_SORTED, HEIGHT_STATE = 14, 0, 18


@pytest.fixture(scope='module')
def jax_rollouts():
    """JAX batched rollouts of the walker with fixed actions (one jit)."""
    jw = jenvs.load('walker', 'walk')
    acts = np.random.RandomState(0).uniform(-1, 1, (T, B, 6)).astype(
        np.float32)

    def fixed(key, t, s, o, carry):
        return jnp.asarray(acts)[t], carry

    rolls = jax.jit(lambda k: jw.get_rollouts_batched(
        k, B, T, policy_batched=fixed))(jax.random.PRNGKey(4))
    return jw, acts, jax.tree_util.tree_map(np.asarray, rolls)


def _reset_state(rolls):
    """The reset EnvState behind the first featured state: the walker's
    reset leaves the unlimited slides (qpos[0], dropped from the featured
    state) at 0 and the velocities at 0."""
    s0 = rolls.states[:, 0]
    qpos = np.concatenate([np.zeros((s0.shape[0], 1), np.float32),
                           s0[:, :8]], 1)
    return convert.env_state(qpos, s0[:, 8:17])


@pytest.fixture(scope='module')
def wrapper():
    return envs.load('walker', 'walk', device='cpu')


def test_featured_state_goal_and_weights_match_jax(jax_rollouts, wrapper):
    jw, _, rolls = jax_rollouts
    assert not rolls.states[:, 0, 8:17].any()          # reset: qvel = 0
    s, o = wrapper._observe_full(_reset_state(rolls))
    np.testing.assert_allclose(s.numpy(), rolls.states[:, 0], atol=1e-5)
    np.testing.assert_allclose(o.numpy(), rolls.observations[:, 0],
                               atol=1e-5)
    assert (wrapper.state_dim, wrapper.observation_dim) == (20, 24)
    assert (jw.state_dim, jw.observation_dim) == (20, 24)
    np.testing.assert_array_equal(wrapper.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    np.testing.assert_array_equal(
        wrapper.set_goal(torch.Generator()).numpy(),
        np.asarray(jw.set_goal(jax.random.PRNGKey(0))))


class _StubEnv:
    """No physics: the state is a counter; the observation dict has keys
    in non-sorted task order, velocity = state, height = state + 100."""

    def _ts(self, s):
        obs = {'velocity': s[None], 'height': s[None] + 100.0}
        return jsuite.control.TimeStep(step_type=jnp.zeros((), jnp.int32),
                                       reward=s, discount=s,
                                       observation=obs)

    def reset(self, key):
        s = jax.random.uniform(key, ())
        return s, self._ts(s)

    def step_with_data(self, s, action):
        s = s + 1.0 + 0.0 * action.sum()
        return s, self._ts(s), None


class _StubWrapper(jenvs.EnvWrapper):
    def __init__(self):
        self._env = _StubEnv()

    def _observe_full(self, s):
        return s[None], jsuite.flatten_observation(self._env._ts(s)
                                                   .observation)

    def get_state(self, s, data=None):
        return s[None]


def test_jax_collectors_flatten_observations_in_two_orders():
    jw = _StubWrapper()
    pol = lambda key, t, s, o, c: (jnp.zeros(s.shape[:-1] + (1,)), c)
    batched = jw.get_rollouts_batched(jax.random.PRNGKey(0), 2, 3, pol)
    per_env = jw.get_rollouts(jax.random.PRNGKey(0), 2, 3, policy=pol)
    for rolls, sorted_later in ((batched, True), (per_env, False)):
        s = np.asarray(rolls.states)[..., 0]
        o = np.asarray(rolls.observations)
        task = np.stack([s, s + 100.0], -1)        # velocity, height
        srt = task[..., ::-1]                      # height, velocity
        np.testing.assert_allclose(o[:, 0], task[:, 0])
        np.testing.assert_allclose(o[:, 1:], (srt if sorted_later
                                              else task)[:, 1:])


def test_batched_collection_matches_jax(jax_rollouts, wrapper):
    """The first control step agrees at atol 1e-4. The float32 physics
    difference then grows ~2.5x per control step in a contact-rich env
    whose velocities reach ~18 (5e-5, 1.4e-4, 3.4e-4 over 10, 20, 30
    substeps), so all three steps are held at rtol 1e-4 beside atol 1e-4."""
    _, acts, rolls = jax_rollouts
    fixed = lambda g, t, s, o, c: (torch.as_tensor(acts[t]), c)
    got = wrapper.collect_from(_reset_state(rolls), T, fixed,
                               torch.Generator())
    np.testing.assert_array_equal(got.actions.numpy(), rolls.actions)
    for f in ('states', 'observations', 'rewards'):
        g, r = getattr(got, f).numpy(), getattr(rolls, f)
        first = 2 if f != 'rewards' else 1
        np.testing.assert_allclose(g[:, :first], r[:, :first], rtol=0,
                                   atol=1e-4, err_msg=f)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=f)
    # the task-order / sorted-order split of the JAX batched collector
    h = got.states[..., HEIGHT_STATE]
    torch.testing.assert_close(got.observations[:, 0, HEIGHT_TASK], h[:, 0])
    torch.testing.assert_close(got.observations[:, 1:, HEIGHT_SORTED],
                               h[:, 1:])


def test_random_collection_flattens_in_task_order(wrapper):
    own = wrapper.get_rollouts(torch.Generator().manual_seed(0), BR, 2)
    assert own.actions.shape == (BR, 2, 6)
    assert own.states.shape == (BR, 3, 20)
    assert float(own.actions.abs().max()) <= 1.0
    np.testing.assert_array_equal(own.observations[..., HEIGHT_TASK].numpy(),
                                  own.states[..., HEIGHT_STATE].numpy())


def _agent(tmp_path, model, seed=0):
    env = envs.load('walker', 'stand', device='cpu')
    dataset = data.init_replay(8, 8, env.state_dim, env.observation_dim,
                               env.action_dim, device='cpu')
    return agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=4, optimizer=Mt.adam(0.01), rollout_length=8,
        num_rollouts_per_iteration=2, num_train_iterations=1,
        writer=MetricsWriter(str(tmp_path)), base_path=str(tmp_path),
        dataset=dataset, seed=seed,
        planner_kwargs=dict(num_candidates=32, num_elites=4,
                            num_iterations=2),
        kernel_kwargs=dict(sampler='triangular', envs_per_program=4),
        train_epochs=1, train_batch_size=16, num_initial_rollouts=2)


@pytest.mark.parametrize('kind', ['nn', 'ens'])
def test_goal_state_agent_trains_and_checkpoints(tmp_path, kind):
    base = models.MLPDynamics(20, 6, hidden_units=16)
    model = base if kind == 'nn' else models.EnsembleDynamics(base, 4)
    agent = _agent(tmp_path, model)
    assert agent.obs_only is False and agent.plan_dim == 20
    agent.train()
    assert agent.dataset.filled == 4 and agent.train_iterations == 1
    for f in ('states', 'observations', 'actions', 'rewards'):
        assert bool(torch.isfinite(getattr(agent.dataset, f)).all())
    tags = {json.loads(line)['tag'] for line in
            open(os.path.join(tmp_path, 'metrics.jsonl'))}
    for tag in ('AvgRolloutRewards/random', 'AvgRolloutRewards/policy',
                'AvgRolloutTotalCosts/policy', 'RolloutStateCosts/policy',
                'loss/state/1'):
        assert tag in tags, tag
    path = os.path.join(tmp_path, 'ckpt', 'agent')
    agents.save(agent, path)
    other = _agent(tmp_path, model, seed=1)
    agents.load(other, path)
    for a, b in zip(Mt.param_leaves(agent.params),
                    Mt.param_leaves(other.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert other.dataset.filled == 4 and other.train_iterations == 1
    torch.testing.assert_close(other.dataset.states, agent.dataset.states)
    assert torch.equal(other.generator.get_state(),
                       agent.generator.get_state())
    assert other.optimizer.state_dict()['state'].keys() == \
        agent.optimizer.state_dict()['state'].keys()


def test_experiment_main_on_cpu(tmp_path):
    args = experiment.parse_args([
        '--exp_dir', str(tmp_path), '--environment', 'walker_walk',
        '--planner', 'cem', '--model', 'ens', '--rollout_length', '4',
        '--num_rollouts_per_iteration', '2', '--num_train_iterations', '1',
        '--train_epochs', '1', '--horizon', '3', '--device', 'cpu',
        '--planner_kwargs',
        '{"num_candidates": 20, "num_elites": 4, "num_iterations": 1}',
        '--kernel_kwargs', '{"sampler": "spline4", "unroll": 2}'])
    agent = experiment.main(args)
    assert isinstance(agent.model, models.EnsembleDynamics)
    assert agent.dataset.filled == 22        # 20 seed + 2 policy rollouts
    for f in ('agent_final.pt', 'config.txt', 'metrics.jsonl',
              'experiment.log'):
        assert os.path.exists(os.path.join(tmp_path, f)), f


def test_unported_choices_raise(tmp_path, wrapper):
    with pytest.raises(NotImplementedError, match='finger'):
        envs.load('finger', 'spin', device='cpu')
    # an ensemble over a non-MLP base is taken, as in JAX: its members'
    # parameters stacked on a leading axis, planned through the scan
    ens = models.EnsembleDynamics(models.LinearDynamics(20, 6), 5)
    params = ens.init(torch.Generator().manual_seed(0), device='cpu')
    assert tuple(params['l1']['w'].shape) == (5, 26, 20)
    assert tuple(ens.forward_ts(params, torch.zeros(10, 20),
                                torch.zeros(10, 6)).shape) == (10, 20)
    # task kwargs are ported: they reach the task's factory, as in JAX,
    # and one the factory does not take raises there
    assert envs.load('walker', 'walk', device='cpu',
                     time_limit=5).env._max_steps == 200
    with pytest.raises(TypeError, match='seed'):
        envs.load('walker', 'walk', device='cpu', seed=3)
