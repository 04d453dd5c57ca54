"""The last API pieces of the JAX package in the port, held to JAX's.

The one-rollout collector (``get_rollout`` / ``rollout_fn``), the DARE's
fixed-point solve and its SciPy-less fallback, ``check_divergence``,
``State.flatten``, ``xmat_of``, ``make_state(dtype=)``,
``math.normalize``, ``TreeMeta.body_order``, ``save_pytree`` /
``load_pytree`` across the packages, ``suite.load``'s JAX keywords and
the packages' entry-point names. Anything that builds a JAX model runs
on the pendulum; tolerances are stated at each check. About 20 s on one
core, most of it JAX's import and compiles.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jax_envs
from mujoco_mbrl_tpu import physics as jax_physics
from mujoco_mbrl_tpu.physics import engine as jax_engine
from mujoco_mbrl_tpu.physics import math as jax_math
from mujoco_mbrl_tpu.physics import smooth as jax_smooth
from mujoco_mbrl_tpu.suite import lqr_solver as jax_lqr_solver
from mujoco_mbrl_tpu.suite import pendulum as jax_pendulum
from mujoco_mbrl_tpu.utils import checkpoint as jax_checkpoint
from mujoco_mbrl_tpu_torch import envs, ops, physics, suite, utils
from mujoco_mbrl_tpu_torch.physics import engine, math, model, smooth
from mujoco_mbrl_tpu_torch.suite import lqr_solver
from mujoco_mbrl_tpu_torch.utils import checkpoint

ROLLOUT_ATOL = 1e-5      # states, observations, actions and rewards
DARE_RTOL = 1e-8         # P against JAX's iteration and SciPy's solver
F32_ATOL = 1e-6          # single forward / vector products in float32

_W = np.array([[0.7], [-0.4], [0.3]], np.float32)    # pendulum obs dim 3


def _jax_policy(key, t, state, obs, carry):
    """Deterministic: tanh(obs W + 0.05 carry), the carry counting steps."""
    a = jnp.tanh(obs @ jnp.asarray(_W) + 0.05 * carry)
    return a, carry + 1.0


def _port_policy(generator, t, state, obs, carry):
    """The same policy in the port's batched protocol at B = 1."""
    a = torch.tanh(obs @ torch.as_tensor(_W) + 0.05 * carry)
    return a, carry + 1.0


@functools.lru_cache(maxsize=None)
def _jax_model(xml):
    return jax_physics.parse(xml)


def _rollouts_close(ours, ref):
    for field in ('states', 'observations', 'actions', 'rewards'):
        np.testing.assert_allclose(
            getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
            atol=ROLLOUT_ATOL, err_msg=field)


@pytest.fixture(scope='module')
def pendulums():
    return (envs.load('pendulum', 'swingup', device='cpu'),
            jax_envs.load('pendulum', 'swingup'))


def test_get_rollout_is_jaxs(pendulums):
    """One rollout of 12 steps from the same initial state: JAX's leading
    axis of 1, T + 1 states and observations, every value within
    ROLLOUT_ATOL of JAX's."""
    ours_env, ref_env = pendulums
    s0 = np.array([2.5, -0.8], np.float32)
    ref = ref_env.get_rollout(jax.random.PRNGKey(0), 12, _jax_policy,
                              initial_state=jnp.asarray(s0),
                              policy_init=lambda: 0.0)
    ours = ours_env.get_rollout(torch.Generator().manual_seed(0), 12,
                                _port_policy,
                                initial_state=torch.as_tensor(s0),
                                policy_init=lambda: 0.0)
    assert ours.states.shape == (1, 13, 2)
    assert ours.observations.shape == (1, 13, 3)
    assert ours.actions.shape == (1, 12, 1)
    assert ours.rewards.shape == (1, 12)
    for field in ('states', 'observations', 'actions', 'rewards'):
        assert getattr(ours, field).shape == np.shape(getattr(ref, field))
    _rollouts_close(ours, ref)


def test_rollout_fn_collector_is_jaxs(pendulums):
    """rollout_fn's collector (generator, goal_state, initial_state), with
    JAX's ignored set_state."""
    ours_env, ref_env = pendulums
    s0 = np.array([-1.2, 0.4], np.float32)
    ref = ref_env.rollout_fn(6, _jax_policy, set_state=True,
                             policy_init=lambda: 0.0)(
        jax.random.PRNGKey(1), None, jnp.asarray(s0))
    collect = ours_env.rollout_fn(6, _port_policy, set_state=True,
                                  policy_init=lambda: 0.0)
    ours = collect(torch.Generator().manual_seed(1), None,
                   torch.as_tensor(s0))
    _rollouts_close(ours, ref)


def test_get_rollout_random_policy_draws_from_the_generator(pendulums):
    """Without a policy the actions are uniform draws: the same generator
    seed gives the same rollout, and it matches get_rollouts at one env."""
    ours_env, _ = pendulums
    a = ours_env.get_rollout(torch.Generator().manual_seed(5), 4)
    b = ours_env.get_rollouts(torch.Generator().manual_seed(5), 1, 4)
    for field in ('states', 'observations', 'actions', 'rewards'):
        assert torch.equal(getattr(a, field), getattr(b, field))
    assert float(a.actions.abs().max()) <= 1.0


def _lqr_dare():
    return lqr_solver._discretize(suite.load('lqr', 'lqr_2_1', device='cpu'))


def test_solve_dare_iter_is_jaxs_and_scipys():
    import scipy.linalg
    a, b, q, r = _lqr_dare()
    ours = lqr_solver.solve_dare_iter(a, b, q, r)
    ref = jax_lqr_solver.solve_dare_iter(a, b, q, r)
    exact = scipy.linalg.solve_discrete_are(a, b, q, r)
    scale = np.abs(exact).max()
    assert np.abs(ours - ref).max() <= DARE_RTOL * scale
    assert np.abs(ours - exact).max() <= DARE_RTOL * scale


def test_solve_without_scipy_takes_the_iteration(monkeypatch):
    """With SciPy's import made to fail, solve's P, K and beta are the
    SciPy path's within DARE_RTOL."""
    env = suite.load('lqr', 'lqr_2_1', device='cpu')
    p_sp, k_sp, beta_sp = lqr_solver.solve(env)
    calls = []
    real = lqr_solver.solve_dare_iter

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(lqr_solver, 'solve_dare_iter', counting)
    monkeypatch.setitem(sys.modules, 'scipy.linalg', None)
    with pytest.raises(ImportError):
        import scipy.linalg  # noqa: F401
    p, k, beta = lqr_solver.solve(env)
    assert calls == [1]
    assert np.abs(p - p_sp).max() <= DARE_RTOL * np.abs(p_sp).max()
    assert np.abs(k - k_sp).max() <= DARE_RTOL * np.abs(k_sp).max()
    assert abs(beta - beta_sp) <= DARE_RTOL


def test_check_divergence_raises_where_jaxs_does():
    """PhysicsError where any env holds a NaN or an exploding velocity, as
    JAX's check raises on the same values; nothing on a finite batch."""
    m = physics.parse(jax_pendulum._XML)
    ok = model.make_state(m, batch=4)
    engine.check_divergence(ok)
    jax_engine.check_divergence(jax_physics.make_state(
        _jax_model(jax_pendulum._XML)))
    assert issubclass(engine.PhysicsError, RuntimeError)
    for field, value in (('qpos', float('nan')), ('qvel', 2e6),
                         ('qvel', float('inf'))):
        bad = getattr(ok, field).clone()
        bad[2, 0] = value
        state = ok.replace(**{field: bad})
        with pytest.raises(engine.PhysicsError, match='1 of 4 envs'):
            engine.check_divergence(state)
        ref = jax_physics.make_state(_jax_model(jax_pendulum._XML))
        ref = ref.replace(**{field: jnp.asarray(bad[2].numpy())})
        with pytest.raises(jax_engine.PhysicsError):
            jax_engine.check_divergence(ref)


_ACT_XML = """
<mujoco model='act'>
  <worldbody>
    <body name='b'>
      <joint name='j' type='hinge' axis='0 1 0'/>
      <geom type='capsule' fromto='0 0 0 0 0 -.5' size='.05'/>
    </body>
  </worldbody>
  <actuator>
    <general joint='j' dyntype='integrator' gainprm='1' ctrlrange='-1 1'
             ctrllimited='true'/>
  </actuator>
</mujoco>"""


@pytest.mark.parametrize('xml', [jax_pendulum._XML, _ACT_XML],
                         ids=['pendulum', 'activation'])
def test_state_flatten_is_jaxs(xml):
    """(B, nq + nv [+ na]): each row JAX's flat vector of that env."""
    m, ref_m = physics.parse(xml), _jax_model(xml)
    rng = np.random.default_rng(0)
    qpos = rng.standard_normal((3, m.nq)).astype(np.float32)
    qvel = rng.standard_normal((3, m.nv)).astype(np.float32)
    act = (torch.as_tensor(rng.standard_normal((3, m.na)), dtype=torch.float32)
           if m.na else None)
    ours = model.make_state(m, qpos=torch.as_tensor(qpos),
                            qvel=torch.as_tensor(qvel), act=act).flatten()
    assert ours.shape == (3, m.nq + m.nv + m.na)
    for i in range(3):
        ref = jax_physics.make_state(
            ref_m, qpos=qpos[i], qvel=qvel[i],
            act=None if act is None else act[i].numpy()).flatten()
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))


def test_xmat_of_is_jaxs():
    """Body rotation matrices of a pendulum forward, within F32_ATOL."""
    m, ref_m = physics.parse(jax_pendulum._XML), _jax_model(jax_pendulum._XML)
    qpos = np.array([[0.3], [-2.1]], np.float32)
    data = physics.forward(m, model.make_state(m, qpos=torch.as_tensor(qpos)),
                           torch.zeros((2, m.nu)), acc_stage=False)
    ours = model.xmat_of(data, m)
    assert ours.shape == (2, m.nbody, 3, 3)
    for i in range(2):
        ref_data = jax_physics.forward(
            ref_m, jax_physics.make_state(ref_m, qpos=qpos[i]),
            jnp.zeros(ref_m.nu), acc_stage=False)
        np.testing.assert_allclose(
            ours[i].numpy(), np.asarray(jax_physics.model.xmat_of(
                ref_data, ref_m)), atol=F32_ATOL)


def test_make_state_dtype():
    """dtype= sets every field's dtype (default: the model's), with JAX's
    values: qpos0, zero velocity, time and activations."""
    m = physics.parse(_ACT_XML)
    ref = jax_physics.make_state(_jax_model(_ACT_XML), dtype=jnp.float32)
    for dtype in (None, torch.float64, torch.float32):
        st = model.make_state(m, batch=2, dtype=dtype)
        want = dtype or m.dtype
        for field in ('qpos', 'qvel', 'time', 'act'):
            ours = getattr(st, field)
            assert ours.dtype == want, (field, dtype)
            np.testing.assert_array_equal(
                ours[0].numpy(), np.asarray(getattr(ref, field)),
                err_msg=field)


def test_normalize_is_jaxs():
    """Unit vectors along the last axis within F32_ATOL; the zero vector
    stays zero (the norm floored at eps), as in JAX."""
    v = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    v[3] = 0.0
    ours = math.normalize(torch.as_tensor(v))
    for i in range(5):
        np.testing.assert_allclose(ours[i].numpy(),
                                   np.asarray(jax_math.normalize(v[i])),
                                   atol=F32_ATOL)
    assert bool((ours[3] == 0).all())


def test_body_order_is_jaxs():
    m = physics.parse(jax_pendulum._XML)
    ref = jax_smooth.tree_meta(_jax_model(jax_pendulum._XML))
    assert smooth.tree_meta(m).body_order == ref.body_order
    assert smooth.tree_meta(m).body_order == tuple(range(m.nbody))


def _tree():
    rng = np.random.default_rng(2)
    return {'w2': rng.standard_normal((3, 2)).astype(np.float32),
            'layers': [{'w': rng.standard_normal((4, 3)).astype(np.float32),
                        'b': np.arange(3, dtype=np.float32)},
                       (np.float32(1.5), None)],
            'count': np.int32(7)}


def _leaves_equal(ours, ref):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)     # JAX's unflatten sorts keys
        for k in ref:
            _leaves_equal(ours[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _leaves_equal(a, b)
    elif ref is None:
        assert ours is None
    else:
        a = ours.numpy() if isinstance(ours, torch.Tensor) else ours
        np.testing.assert_array_equal(np.asarray(a), np.asarray(ref))
        assert np.asarray(a).dtype == np.asarray(ref).dtype


def test_save_pytree_round_trips_across_the_packages(tmp_path):
    """A tree saved by either package loads in the other, bit for bit,
    and both write the same treedef record."""
    tree = _tree()
    torch_tree = jax.tree_util.tree_map(torch.as_tensor, tree)
    checkpoint.save_pytree(str(tmp_path / 'ours'), torch_tree)
    jax_checkpoint.save_pytree(str(tmp_path / 'ref'), tree)
    _leaves_equal(jax_checkpoint.load_pytree(str(tmp_path / 'ours'), tree),
                  tree)
    _leaves_equal(checkpoint.load_pytree(str(tmp_path / 'ref'), torch_tree),
                  tree)
    _leaves_equal(utils.load_pytree(str(tmp_path / 'ours'), torch_tree),
                  tree)
    assert (json.load(open(tmp_path / 'ours.tree.json'))
            == json.load(open(tmp_path / 'ref.tree.json')))


def test_suite_load_takes_jaxs_keywords():
    """domain_name= / task_name= as in JAX; domain= / task= and the
    positional form as before; build_environment is the worker."""
    forms = [suite.load(domain_name='point_mass', task_name='easy',
                        device='cpu'),
             suite.load(domain='point_mass', task='easy', device='cpu'),
             suite.load('point_mass', 'easy', device='cpu'),
             suite.build_environment('point_mass', 'easy', device='cpu')]
    for env in forms:
        assert isinstance(env, suite.Environment)
        assert env.max_steps == forms[0].max_steps == 1000
        assert env.control_timestep() == forms[0].control_timestep()
    with pytest.raises(TypeError):
        suite.load(task_name='easy', device='cpu')
    with pytest.raises(ValueError, match='does not exist'):
        suite.load(domain_name='point_mass', task_name='nope', device='cpu')
    assert suite.all_tasks() is suite.ALL_TASKS
    assert suite.benchmarking() is suite.BENCHMARKING
    assert ('point_mass', 'easy') in suite.ALL_TASKS


def test_entry_point_names():
    """JAX's package-level names, each the port's own object."""
    assert physics.step is engine.step and physics.forward is engine.forward
    assert physics.substep is engine.substep
    assert physics.n_substeps is engine.n_substeps
    assert physics.Option is model.Option
    assert physics.parse is physics.mjcf.parse
    from mujoco_mbrl_tpu_torch.envs import wrappers
    for name in ('PointMass', 'Reacher', 'Cartpole', 'Pendulum'):
        assert getattr(envs, name) is getattr(wrappers, name)
    from mujoco_mbrl_tpu_torch.ops import cem_rollout
    for name in ('mlp_rollout_costs', 'mlp_rollout_costs_reference',
                 'mlp_rollout_costs_t', 'mlp_sample_rollout_costs',
                 'mlp_sample_rollout_costs_ensemble'):
        assert getattr(ops, name) is getattr(cem_rollout, name)
    from mujoco_mbrl_tpu_torch.utils import jacobian
    assert utils.compute_jacobian is jacobian.compute_jacobian
    assert utils.save_pytree is checkpoint.save_pytree


def test_humanoid_cmu_attempts_keyword():
    """attempts= (JAX's default 10): one attempt keeps each env's first
    draw; the default is the explicit 10."""
    from mujoco_mbrl_tpu_torch.suite import randomizers
    env = suite.load('humanoid_cmu', 'stand', device='cpu')
    draw = lambda **kw: env.task.initialize_episode(
        env.model, 3, torch.Generator().manual_seed(4), **kw)[0].qpos
    assert torch.equal(draw(), draw(attempts=10))
    first = randomizers.randomize_limited_and_rotational_joints(
        env.model, env.model.qpos0.expand(3, env.model.nq),
        torch.Generator().manual_seed(4))
    assert torch.equal(draw(attempts=1), first)


def test_metrics_writer_tensorboard_is_jaxs(tmp_path, monkeypatch):
    """use_tensorboard=True hands the jsonl's scalars and histograms to
    torch's SummaryWriter as JAX's writer does (both given a fake writer:
    the real one imports TensorFlow here, ~15 s, which is why the port's
    default is off); the jsonl records are JAX's."""
    import types

    from mujoco_mbrl_tpu.utils import metrics as jax_metrics

    def fake(calls):
        class SummaryWriter:
            def __init__(self, log_dir):
                calls.append(('init',))

            def add_scalar(self, tag, value, step):
                calls.append(('scalar', tag, value, step))

            def add_histogram(self, tag, values, step):
                calls.append(('hist', tag, np.asarray(values).tolist(), step))

            def close(self):
                calls.append(('close',))
        return types.SimpleNamespace(SummaryWriter=SummaryWriter)

    runs = {}
    for name, writer_cls, value in (
            ('ours', utils.MetricsWriter, torch.tensor(1.5)),
            ('ref', jax_metrics.MetricsWriter, jnp.asarray(1.5))):
        calls = []
        monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard',
                            fake(calls))
        w = writer_cls(str(tmp_path / name), use_tensorboard=True)
        w.add_scalar('loss', value, 3)
        w.add_histogram('costs', [1.0, 2.0, 4.0], 4)
        w.close()
        rows = [json.loads(line)
                for line in open(tmp_path / name / 'metrics.jsonl')]
        runs[name] = (calls, [{k: v for k, v in r.items() if k != 't'}
                              for r in rows])
    assert runs['ours'] == runs['ref']
    assert runs['ours'][0][0] == ('init',)
    calls = []
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', fake(calls))
    utils.MetricsWriter(str(tmp_path / 'off')).close()
    assert calls == []
