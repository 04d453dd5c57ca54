"""The contact-free domains (reacher, point_mass, pendulum), port against
the JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages:

* each domain's ``_XML`` is the JAX module's;
* the compiled models of the five tasks, field by field (body mass and
  inertia from sphere and capsule geoms, ``tendon_moment``, actuator
  transmissions, ``disableflags``; rtol 1e-5);
* three control steps from JAX-drawn reset states and params (the
  reacher's target, point_mass:hard's tendon directions) with numpy
  actions: qpos, qvel, observation and reward (rtol 1e-5, atol 1e-6);
* the CPU golden fixtures of tests/test_golden_trajectories.py from the
  JAX-drawn reset and actions (its tolerance: rtol 2e-4, atol 2e-5);
* the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py THRESHOLDS;
* each wrapper's featured state, goal weights, ``goal_xy`` / ``apply_goal``
  and first observation with a goal applied (rtol 1e-5);
* point_mass:hard's tendon directions from the JAX task's own normals,
  with candidates rejected and not (rtol 1e-6);
* the fixed-tendon spring and damper (no suite task sets one) on a
  stiffened point_mass model (rtol 1e-5);
* the dense APGD plain twin at 1 and 2 rows (the reacher's wrist limit,
  the point_mass's slide limits) on solves captured from the port, active
  and inactive, against the XLA iterate and, for the cold solve, the JAX
  Pallas kernel in interpret mode (rtol = atol = 2e-4, as
  tests/test_torch_apgd.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.suite import pendulum as jpendulum
from mujoco_mbrl_tpu.suite import point_mass as jpoint_mass
from mujoco_mbrl_tpu.suite import reacher as jreacher
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import (EnvState, pendulum, point_mass,
                                         reacher)
from parity_utils import steps_within
from test_parity_physics import THRESHOLDS
from test_torch_apgd import _jax_pallas, _jax_xla

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
TASKS = [('reacher', 'easy'), ('reacher', 'hard'), ('point_mass', 'easy'),
         ('point_mass', 'hard'), ('pendulum', 'swingup')]
B = 4
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('ours,ref', [(reacher, jreacher),
                                      (point_mass, jpoint_mass),
                                      (pendulum, jpendulum)])
def test_xml_is_a_copy(ours, ref):
    assert ours._XML == ref._XML


_JENVS = {}


def _jenv(domain, task):
    if (domain, task) not in _JENVS:
        _JENVS[domain, task] = jsuite.load(domain, task)
    return _JENVS[domain, task]


@pytest.mark.parametrize('domain,task', TASKS)
def test_model_matches_jax_field_by_field(domain, task):
    jm = _jenv(domain, task).model
    tm = suite.load(domain, task, device='cpu').model
    for f in dataclasses.fields(tm):
        if f.name == 'opt':
            continue
        ours, ref = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(ours, torch.Tensor):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7, err_msg=f.name)
        elif f.name == 'names':
            for kind, table in ours.items():
                assert table == ref.get(kind, {}), kind
        else:
            assert ours == ref, f.name
    for name in ('integrator', 'disableflags', 'solver_iterations', 'solver',
                 'cone', 'impratio', 'solver_warmstart'):
        assert getattr(tm.opt, name) == getattr(jm.opt, name), name
    assert tm.opt.disableflags & 1, 'contacts are not disabled'


def _to_torch(x):
    return torch.as_tensor(np.array(x))


def _port_state(jstate):
    """The port's batched EnvState from a vmapped JAX EnvState."""
    params = jax.tree_util.tree_map(_to_torch, jstate.params)
    if isinstance(params, list):
        params = tuple(params)
    phys = jstate.physics
    return EnvState(physics=State(qpos=_to_torch(phys.qpos),
                                  qvel=_to_torch(phys.qvel),
                                  time=_to_torch(phys.time),
                                  act=(None if phys.act is None
                                       else _to_torch(phys.act))),
                    params=params, step_count=_to_torch(jstate.step_count),
                    last=_to_torch(jstate.last))


def _jax_reset(jenv, n, seed):
    return jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(seed), n))


@pytest.mark.parametrize('domain,task', [
    ('reacher', 'easy'), ('point_mass', 'easy'), ('point_mass', 'hard'),
    ('pendulum', 'swingup')])
def test_control_steps_match_jax(domain, task):
    """Three control steps from JAX-drawn resets and params (reacher:hard
    differs from easy only in the target size, held in the model test)."""
    jenv = _jenv(domain, task)
    env = suite.load(domain, task, device='cpu')
    jstate, jts = _jax_reset(jenv, B, 3)
    state = _port_state(jstate)
    _, ts = env.start(state.physics, state.params)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts.observation[k]),
                                   err_msg=k, **STEP_TOL)
    rng = np.random.RandomState(5)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(3):
        a = rng.uniform(-1, 1, (B, env.model.nu)).astype(np.float32)
        jstate, jts = jstep(jstate, jnp.asarray(a))
        state, ts = env.step(state, torch.as_tensor(a))
        np.testing.assert_allclose(state.physics.qpos.numpy(),
                                   np.asarray(jstate.physics.qpos),
                                   **STEP_TOL)
        np.testing.assert_allclose(state.physics.qvel.numpy(),
                                   np.asarray(jstate.physics.qvel),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                                   **STEP_TOL)
        for k, v in ts.observation.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jts.observation[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize('domain,task', [('pendulum', 'swingup'),
                                         ('reacher', 'easy'),
                                         ('point_mass', 'easy')])
def test_golden_fixture(domain, task):
    """tests/test_golden_trajectories.py's rollout (seed 1234, 15 steps)
    from the JAX-drawn reset and actions, stepped by the port."""
    golden = np.load(os.path.join(FIXTURES, f'golden_{domain}_{task}.npz'))
    jenv = _jenv(domain, task)
    key = jax.random.PRNGKey(1234)
    jstate, _ = jax.jit(jenv.reset)(key)
    spec = jenv.action_spec()
    actions = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 1), (15,) + spec.shape,
        minval=spec.minimum, maxval=spec.maximum))
    state = _port_state(jax.tree_util.tree_map(lambda x: x[None], jstate))
    env = suite.load(domain, task, device='cpu')
    qpos, rewards = [], []
    for a in actions:
        state, ts = env.step(state, torch.as_tensor(a)[None])
        qpos.append(state.physics.qpos[0].numpy())
        rewards.append(float(ts.reward[0]))
    np.testing.assert_allclose(np.array(qpos), golden['qpos'], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(np.array(rewards), golden['rewards'],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('domain,task', TASKS)
def test_tracks_mujoco_fixture(domain, task):
    """The port alone from the oracle's post-reset state, the recorded
    ctrl held over the substeps, within the CPU band."""
    min_steps, tol = THRESHOLDS[(domain, task)]
    fix = np.load(os.path.join(FIXTURES, 'parity', f'{domain}_{task}.npz'))
    m = suite.load(domain, task, device='cpu').model
    ctrl = np.repeat(fix['ctrl'], int(fix['n_sub_steps']), axis=0)
    s = State(qpos=torch.tensor(fix['init_qpos'], dtype=torch.float32)[None],
              qvel=torch.tensor(fix['init_qvel'], dtype=torch.float32)[None],
              time=torch.zeros(1))
    qpos = [fix['init_qpos']]
    for u in ctrl[:min_steps]:
        s = engine.step(m, s, torch.tensor(u, dtype=torch.float32)[None])
        qpos.append(s.qpos[0].numpy())
    k, dev = steps_within(np.array(qpos), fix['p_qpos'], tol)
    assert k >= min(min_steps, len(qpos) - 1), (k, dev[:k + 3])


def _jax_wrapper(domain, task):
    """The JAX wrapper of domain/task, made without its observation-spec
    reset (an eager JAX reset costs ~14 s on the CPU; its dims come from a
    jitted one)."""
    cls = jenvs.wrappers._WRAPPERS[''.join(
        p.capitalize() for p in domain.split('_'))]
    dt = cls.override_control_timestep
    env = (jsuite.load(domain, task,
                       environment_kwargs=dict(control_timestep=dt))
           if dt is not None else _jenv(domain, task))
    w = cls.__new__(cls)
    w._env, w._state_penalty, w.action_dim = env, 1.0, env.model.nu
    _, ts = jax.jit(env.reset)(jax.random.PRNGKey(0))
    w.observation_dim = int(sum(np.size(v) for v in ts.observation.values()))
    if getattr(cls, 'state_dim', None) is None:
        w.state_dim = env.model.nq + env.model.nv
    return w


@pytest.mark.parametrize('domain,task', [('reacher', 'easy'),
                                         ('point_mass', 'easy'),
                                         ('point_mass', 'hard'),
                                         ('pendulum', 'swingup')])
def test_wrapper_matches_jax(domain, task):
    """Featured state, goal weights, the goal written into the params and
    the first observation it gives, from JAX-drawn resets."""
    jw = _jax_wrapper(domain, task)
    w = envs.load(domain, task, device='cpu')
    assert (w.state_dim, w.observation_dim, w.action_dim) == (
        jw.state_dim, jw.observation_dim, jw.action_dim)
    assert w.env._n_sub_steps == jw.env._n_sub_steps
    np.testing.assert_array_equal(w.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    rng = np.random.RandomState(7)
    goal = np.zeros(jw.get_goal_weights().shape[0], np.float32)
    goal[:2] = rng.uniform(-0.25, 0.25, 2) if domain == 'point_mass' else (
        rng.uniform(-2.8, 2.8, 2))
    jstate, _ = _jax_reset(jw.env, B, 11)
    state = w.apply_goal(_port_state(jstate), torch.as_tensor(goal))
    js, jo, jparams = jax.jit(jax.vmap(lambda s: (
        *jw._observe_full(jw.apply_goal(s, jnp.asarray(goal))),
        jw.apply_goal(s, jnp.asarray(goal)).params)))(jstate)
    for ours, ref in zip(jax.tree_util.tree_leaves(state.params),
                         jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   **STEP_TOL)
    s, o = w._observe_full(state)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STEP_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **STEP_TOL)
    if domain == 'reacher':
        angles = rng.uniform(-3, 3, (16, 4)).astype(np.float32)
        np.testing.assert_allclose(
            w.goal_xy(torch.as_tensor(angles)).numpy(),
            np.asarray(jax.jit(jax.vmap(jw.goal_xy))(jnp.asarray(angles))),
            **STEP_TOL)
    g = torch.Generator().manual_seed(0)
    assert w.set_goal(g).shape == (jw.get_goal_weights().shape[0],)
    if domain != 'pendulum':
        # the box of the JAX wrapper's sample_state, per coordinate
        bound = np.array({'reacher': [np.pi, 2.8, 3, 3],
                          'point_mass': [.29, .29, 1, 1]}[domain], np.float32)
        x = w.sample_state(g, (500,)).abs().numpy()
        assert x.shape == (500, w.state_dim)
        assert (x <= bound + 1e-6).all() and (x.max(0) > 0.9 * bound).all()


def _captured_solves(domain, task, qpos, qvel):
    """Inputs of the port's dense APGD solve at given states (zero ctrl):
    the cold first solve and the warm one after it."""
    m = suite.load(domain, task, device='cpu').model
    state = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
                  time=torch.zeros(qpos.shape[0]))
    captured, real = [], apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    zero = torch.zeros((qpos.shape[0], m.nu))
    apgd_solve.apgd_iterate_batched = capture
    try:
        s1, f, v = engine.step_warm(m, state, zero)
        engine.step_warm(m, s1, zero, warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_batched = real
    return captured


def limit_states(domain, n, seed, active=True):
    """(qpos, qvel) float32 at which the limit rows are active (a joint
    past its limit, moving outward) or all inactive (inside, at rest):
    the reacher's wrist at +-2.79..2.83 rad (limit 160 deg = 2.793), the
    point_mass's slides at +-0.285..0.30 (limit 0.29)."""
    rng = np.random.RandomState(seed)
    sign = rng.choice([-1.0, 1.0], n)
    if domain == 'reacher':
        qpos = np.stack([rng.uniform(-np.pi, np.pi, n),
                         sign * rng.uniform(2.79, 2.83, n)], 1)
        qvel = np.stack([rng.normal(size=n), sign * rng.uniform(1, 3, n)], 1)
        if not active:
            qpos[:, 1] *= 0.5
    else:
        qpos = sign[:, None] * rng.uniform(0.285, 0.30, (n, 2))
        qvel = sign[:, None] * rng.uniform(0.5, 2.0, (n, 2))
        if not active:
            qpos *= 0.5
    if not active:
        qvel = np.zeros_like(qvel)
    return qpos.astype(np.float32), qvel.astype(np.float32)


@pytest.mark.parametrize('domain,task,nr', [('reacher', 'easy', 1),
                                            ('point_mass', 'easy', 2)])
@pytest.mark.parametrize('active', [True, False])
def test_apgd_plain_at_one_and_two_rows_matches_jax(domain, task, nr,
                                                    active):
    cases = _captured_solves(domain, task,
                             *limit_states(domain, 8, 3, active))
    assert [kw['cold'] for _, kw in cases] == [True, False]
    for args, kw in cases:
        assert args[0].shape[1:] == (nr, nr)
        n_active = int(args[4].sum())
        assert (2 * n_active >= args[4].size if active
                else n_active == 0), n_active
        jkw = dict(nonneg=kw['nonneg'], box=kw['box_rows'],
                   con0=kw['con0'], iterations=kw['iterations'],
                   cold=kw['cold'], eq_rows=kw['eq_rows'])
        out = apgd_solve.apgd_iterate_batched(
            *[torch.as_tensor(a) for a in args], **kw)
        refs = [_jax_xla(args, **jkw)]
        if kw['cold']:        # one interpret-mode run keeps the file quick
            refs.append(_jax_pallas(args, **jkw))
        for ref in refs:
            np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=2e-4,
                                       atol=2e-4)
        if active:
            assert float(np.abs(out[0].numpy()).max()) > 1e-3


def test_tendon_directions_match_jax():
    """point_mass:hard's rejection-sampled actuation directions: the JAX
    task's own normals (its key splits) through ``tendon_directions``
    against the tendon_moment its ``initialize_episode`` returns, on keys
    where the first candidate is taken and where the first few are
    rejected (rtol 1e-6)."""
    jm = _jenv('point_mass', 'hard').model
    task = jpoint_mass.PointMass(randomize_gains=True)
    keys = jax.random.split(jax.random.PRNGKey(7), 64)

    def draw(key):
        kd1, kd2 = jax.random.split(jax.random.split(key)[1])
        return (jax.random.normal(kd1, (2,)),
                jax.random.normal(kd2, (point_mass._DIRECTION_TRIALS, 2)))

    n1, n2 = jax.vmap(draw)(keys)
    ref = jax.vmap(lambda k: task.initialize_episode(jm, k)[1][1])(keys)
    ref = np.asarray(ref)
    # the index of the candidate JAX took
    cands = np.asarray(n2) / np.linalg.norm(np.asarray(n2), axis=-1,
                                            keepdims=True)
    taken = np.array([int(np.argmin(np.abs(c - r[1]).sum(-1)))
                      for c, r in zip(cands, ref)])
    assert (taken == 0).any() and (taken >= 2).any(), taken
    out = point_mass.tendon_directions(_to_torch(n1), _to_torch(n2))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_tendon_spring_damper_matches_jax():
    """The fixed-tendon passive force (no suite task sets it): point_mass
    with a stiff, damped tendon, passive and actuator forces at random
    states against JAX (rtol 1e-5)."""
    from mujoco_mbrl_tpu.physics import engine as jengine
    from mujoco_mbrl_tpu.physics import mjcf as jmjcf
    from mujoco_mbrl_tpu.physics import model as JM
    from mujoco_mbrl_tpu_torch.physics import mjcf
    xml = jpoint_mass._XML.replace("<fixed name='t1'>",
                                   "<fixed name='t1' stiffness='2' "
                                   "damping='0.5'>")
    jm, tm = jmjcf.parse(xml), mjcf.parse(xml)
    rng = np.random.RandomState(2)
    qpos = rng.uniform(-0.3, 0.3, (B, 2)).astype(np.float32)
    qvel = rng.normal(size=(B, 2)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    jd = jax.jit(jax.vmap(lambda q, v, u: jengine.forward(
        jm, JM.make_state(jm, qpos=q, qvel=v), u)))(qpos, qvel, ctrl)
    td = engine.forward(tm, State(qpos=torch.as_tensor(qpos),
                                  qvel=torch.as_tensor(qvel),
                                  time=torch.zeros(B)), torch.as_tensor(ctrl))
    assert float(np.abs(np.asarray(jd.qfrc_passive)).max()) > 0.1
    for name in ('qfrc_passive', 'qfrc_actuator', 'qacc'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_entry_points_default_to_the_card():
    """The new domains, wrappers, CLI choices and preset run on ``cuda``
    unless given the CPU, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import bench, experiment
    for domain, task in TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load(domain, task)
        with pytest.raises(RuntimeError, match='CUDA'):
            envs.load(domain, task)
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'point_mass_easy']))
    cfg = bench.config('reacher256')
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.build_bench(cfg['task'], 2, 8, 3, 1, 1)
