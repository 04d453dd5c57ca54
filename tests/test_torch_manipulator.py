"""manipulator (a tendon-equality row, 452-row dense solves, per-env body
poses, the Manipulator wrapper), port against the JAX package.

Same inputs, drawn with numpy or torch from a seed or by the JAX reset, go
through both packages (B = 4; one jitted JAX call, module scoped, covers
the reset with its attempts, a control step, the wrapper's state, the
forward and rows on poses in contact and kinematics with per-env poses):

* ``_make_model_xml`` makes the JAX module's XML, and the compiled models
  of the four tasks match field by field (rtol 1e-5; the invweights of
  mj_setConst at rtol 1e-3 of the float64 compile, see
  ``assert_invweights_close``): the equality row's tendon, solref and
  solimp, the pinch body's ``<inertial>``, the slot's boxes;
* on bring_ball poses in contact, the port's model given JAX's
  invweights: the 452 constraint rows in JAX's order
  (the equality row, 7 arm limits, 148 elliptic cone triples; the block
  list, J, aref, R, active and mu at rtol 1e-5), the solve's forces
  and the five touch sensors read from them (rtol 1e-3: where two float32
  iterates stop on these stiff rows);
* #1's plain twin on the cold and warm 452-row solves of two substeps
  from those poses, with the equality polish, against JAX's vmapped XLA
  iterate (``_apgd_dispatch(...).impl_fn``; JAX's kernel takes at most 96
  rows) at rtol = atol = 2e-4;
* kinematics with per-env ``body_pos`` / ``body_quat`` (the target body,
  whose shared quaternion is the identity, moved and turned per env)
  against JAX's on the traced model (rtol = atol = 1e-5);
* the reset's rejection rule on JAX's own eight attempts an env; one
  control step (10 substeps) from the JAX-drawn resets with numpy
  actions: qpos, qvel, reward, observation and the wrapper's featured
  state (atol = rtol = 1e-4);
* the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py HEAVY_THRESHOLDS (8 steps for the ball
  tasks, 55 for the peg tasks, at 1e-3; port-only runs);
* the Manipulator wrapper's dims, goal weights and goal; a tiny
  GoalStateAgent loop on the CPU; the CLI failing where JAX's does.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import manipulator as jmanipulator
from mujoco_mbrl_tpu.suite import sensors as jsensors
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import manipulator, randomizers
from test_parity_physics import HEAVY_THRESHOLDS
from test_torch_cartpole import (APGD_TOL, B, PHYS_TOL, STEP_TOL,
                                 assert_model_matches, jenv_of,
                                 tracks_mujoco_fixture)
from test_torch_contact_free import _port_state
from test_torch_finger import capture_solves

HEAVY = os.environ.get('RUN_HEAVY', '') == '1'
TASKS = ('bring_ball', 'bring_peg', 'insert_ball', 'insert_peg')
NR = 452
CONE_ROWS = tuple(range(8, NR, 3))
SITES = manipulator._TOUCH_SITES


def jax_iterate(args, kw):
    """JAX's iterate on a batch: the vmapped XLA ``impl`` of
    ``_apgd_dispatch`` (mu and bounds shared), in float32 at the highest
    matmul precision."""
    cv = jsolver._apgd_dispatch(kw['nonneg'], kw['box_rows'], kw['con0'],
                                kw['iterations'], kw['cold'], kw['eq_rows'])
    fn = jax.jit(jax.vmap(cv.impl_fn, in_axes=(0, 0, 0, 0, 0, None, None)))
    with jax.default_matmul_precision('highest'):
        return [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]


def recording_init(task, jm, key):
    """JAX's episode init of one env with its eight attempts: ``jax.vmap``
    of the task's ``try_one`` is watched while the init is traced, and
    its (qpos, params, penetrating) returned beside the physics and
    params it picked."""
    seen, real = [], jax.vmap

    def vmap(f, *a, **k):
        g = real(f, *a, **k)
        if getattr(f, '__name__', '') != 'try_one':
            return g

        def run(*args):
            out = g(*args)
            seen.append(out)
            return out
        return run

    jax.vmap = vmap
    try:
        phys, params = task.initialize_episode(jm, key)
    finally:
        jax.vmap = real
    return phys, params, seen[0]


def jax_env_state(jenv, phys, params, observe=True):
    """The JAX EnvState of an episode's first step (the body of the JAX
    ``Environment.reset`` after its init) and, with ``observe``, its
    observation."""
    from mujoco_mbrl_tpu.suite import control as jcontrol
    state = jcontrol.EnvState(physics=phys, params=params,
                              step_count=jnp.zeros((), jnp.int32),
                              last=jnp.zeros((), jnp.bool_))
    if not observe:
        return state
    return state, jenv._observe(jenv._model_with(params), phys, params)


def contact_poses(tm, n, seed):
    """bring_ball poses of the reset's draws that penetrate by under 1 cm
    (arm, fingers, ball, floor and walls in contact), random velocities
    and controls."""
    qposes, _ = BRING_BALL.attempts(tm, 64, torch.Generator().manual_seed(seed))
    q = qposes.reshape(-1, tm.nq)
    kin = smooth.kinematics(tm, q, smooth.tree_meta(tm))
    dist = collision.detect(tm, kin[3], kin[4],
                            collision.candidate_pairs(tm)).dist
    keep = ((dist < 0).any(1) & (dist > -0.01).all(1)).nonzero()[:, 0]
    assert len(keep) >= n
    rng = np.random.RandomState(seed)
    qvel = rng.normal(0.0, 0.3, (n, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1.0, 1.0, (n, tm.nu)).astype(np.float32)
    return q[keep[:n]].numpy(), qvel, ctrl


BRING_BALL = manipulator.Bring(use_peg=False, insert=False,
                               fully_observable=True)


@pytest.fixture(scope='module')
def port_env():
    return suite.load('manipulator', 'bring_ball', device='cpu')


def jax_wrapper(jenv):
    jwrap = object.__new__(jenvs.wrappers.Manipulator)
    jwrap._env, jwrap._state_penalty = jenv, 1.0
    jwrap.action_dim = jenv.model.nu
    return jwrap


@pytest.fixture(scope='module')
def jax_run(port_env):
    """One jitted JAX call: B episode inits with their attempts; on poses
    in contact the kinematics, motion subspace, contacts and constraint
    rows (no solve: the JAX forward's compile is gated, see
    ``test_solve_and_touch_match_jax``); kinematics with the target moved
    per env."""
    jenv = jenv_of('manipulator', 'bring_ball')
    jm, task = jenv.model, jenv._task
    qc, vc, uc = contact_poses(port_env.model, B, seed=0)
    rng = np.random.RandomState(2)
    kin_params = np.stack([rng.uniform(-.4, .4, B), rng.uniform(.1, .4, B),
                           rng.uniform(-np.pi, np.pi, B)], 1).astype(
                               np.float32)
    blocks = []

    def body(key, q, v, p):
        phys, params, attempts = recording_init(task, jm, key)
        meta = jsmooth.tree_meta(jm)
        kin = jsmooth.kinematics(jm, q, meta)
        cdof = jsmooth.motion_subspace(jm, kin[1], kin[6], kin[7], meta)
        con = jcollision.detect(jm, kin[3], kin[4],
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, meta, q, v, cdof, con, site_xpos=kin[5])
        blocks[:] = [cs.blocks]
        moved = task.apply_params(jm, p)
        kin_moved = jsmooth.kinematics(moved, q, jsmooth.tree_meta(moved))
        return dict(phys=phys, params=params, attempts=attempts,
                    rows=(cs.J, cs.aref, cs.R, cs.active, cs.mu),
                    kin=kin_moved[:6])

    keys = jax.random.split(jax.random.PRNGKey(5), B)
    with jax.default_matmul_precision('highest'):
        out = jax.jit(jax.vmap(body))(keys, qc, vc, kin_params)
    out = jax.tree_util.tree_map(np.asarray, out)
    out.update(blocks=blocks[0], qc=qc, vc=vc, uc=uc, kin_params=kin_params,
               jwrap=jax_wrapper(jenv))
    return out


INVWEIGHTS = ('dof_invweight0', 'body_invweight0', 'tendon_invweight0')


def assert_invweights_close(jm, tm, xml):
    """The mj_setConst weights at qpos0 of both packages within rtol 1e-3
    of the port's float64 compile: both invert a float32 mass matrix whose
    condition number the near-massless fingers (1e-6 kg pinch body) push
    past 1e5, so their float32 roundings part from it by up to 6.3e-4
    relative, and from each other by 1.3e-4 (rtol 1e-5 for every other
    field). The row and solve tests give the port JAX's weights
    (``with_jax_invweights``), so that they compare the rows and the
    solve, not this rounding."""
    from mujoco_mbrl_tpu_torch.physics import mjcf
    m64 = mjcf.parse(xml, dtype=torch.float64)
    for name in INVWEIGHTS:
        ref = getattr(m64, name).numpy()
        for x in (getattr(tm, name).numpy(), np.asarray(getattr(jm, name))):
            np.testing.assert_allclose(x, ref, rtol=1e-3, atol=0,
                                       err_msg=name)


def with_jax_invweights(tm, jm):
    """The port's model with the JAX model's mj_setConst weights."""
    return tm.replace(**{n: torch.as_tensor(np.asarray(getattr(jm, n)))
                         for n in INVWEIGHTS})


def test_xml_is_a_copy():
    for use_peg in (False, True):
        for insert in (False, True):
            assert manipulator._make_model_xml(use_peg, insert) == (
                jmanipulator._make_model_xml(use_peg, insert))


@pytest.mark.parametrize('task', [
    'bring_ball',
    pytest.param('insert_peg', marks=pytest.mark.skipif(
        not HEAVY, reason='~7 s of JAX compile on one core; RUN_HEAVY=1')),
    pytest.param('bring_peg', marks=pytest.mark.skipif(
        not HEAVY, reason='~6 s of JAX compile on one core; RUN_HEAVY=1')),
    pytest.param('insert_ball', marks=pytest.mark.skipif(
        not HEAVY, reason='~6 s of JAX compile on one core; RUN_HEAVY=1'))])
def test_model_matches_jax_field_by_field(task):
    jm = jenv_of('manipulator', task).model
    tm = suite.load('manipulator', task, device='cpu').model
    assert_model_matches(jm, tm, held_apart=INVWEIGHTS)
    assert_invweights_close(jm, tm, manipulator._make_model_xml(
        'peg' in task, 'insert' in task))
    assert tm.eq_tendon == ((tm.name2id('tendon', 'coupling'),
                             (0.005, 0.5), (0.95, 0.99, 0.001, 0.5, 2.0)),)
    assert tm.opt.cone == 'elliptic' and tm.nq == tm.nv == 11
    pinch = tm.name2id('body', 'pinch site')
    assert float(tm.body_mass[pinch]) == pytest.approx(1e-6)
    np.testing.assert_allclose(tm.body_inertia[pinch].numpy(),
                               1e-12 * np.eye(3), rtol=1e-6, atol=0)


@pytest.fixture(scope='module')
def tm_jiw(port_env):
    return with_jax_invweights(port_env.model, jenv_of(
        'manipulator', 'bring_ball').model)


def test_452_rows_in_jax_order(tm_jiw, jax_run):
    """The equality row, 7 arm limits, then 148 contact points (118
    pairs) as elliptic cone triples, in JAX's order and values."""
    tm = tm_jiw
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(jenv_of(
        'manipulator', 'bring_ball').model) and len(pairs) == 118
    ts = State(qpos=torch.as_tensor(jax_run['qc']),
               qvel=torch.as_tensor(jax_run['vc']), time=torch.zeros(B))
    td = engine.forward(tm, ts, torch.as_tensor(jax_run['uc']))
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat, pairs)
    cs = solver.assemble(tm, smooth.tree_meta(tm), ts.qpos, ts.qvel,
                         td.cdof, con, site_xpos=td.site_xpos)
    assert cs.J.shape == (B, NR, 11)
    assert cs.blocks == jax_run['blocks']
    assert [k for k, _ in cs.blocks] == (['equality'] + ['limit'] * 7
                                         + ['contact'] * 148)
    assert [i for k, i in cs.blocks if k == 'contact'] == list(CONE_ROWS)
    jJ, jaref, jR, jact, jmu = jax_run['rows']
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               (jJ, jaref, jR, jact),
                               ('J', 'aref', 'R', 'active')):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    np.testing.assert_allclose(cs.mu.numpy(), jmu[0], rtol=1e-6)
    act = cs.active.numpy()
    assert act[:, 0].all() and act[:, 8:].sum() >= 3 * B


@pytest.mark.skipif(not HEAVY, reason='the JAX forward with its 452-row '
                    'solve and touch compiles in ~40 s on one core; '
                    'RUN_HEAVY=1')
def test_solve_and_touch_match_jax(tm_jiw, jax_run):
    """The forward's 452-row solve and the five touch sensors read from
    the cone rows, at rtol 1e-3: the rows agree at 1e-5, and each
    package's float32 iterate stops once a step moves f by under 1e-6 of
    its norm, which on these stiff rows (the equality row's J M^-1 J'
    ~2e5) leaves the two stopping points up to 8e-4 apart; #1's plain
    twin on the same rows is held to JAX's iterate at 2e-4 below."""
    jm = jenv_of('manipulator', 'bring_ball').model

    def fwd(q, v, u):
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v,
                                         time=jnp.zeros(())), u)
        return d, jnp.stack([jsensors.touch(jm, d, jm.name2id('site', s))
                             for s in SITES])

    with jax.default_matmul_precision('highest'):
        jd, jtouch = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(
            fwd))(jax_run['qc'], jax_run['vc'], jax_run['uc']))
    tm = tm_jiw
    ts = State(qpos=torch.as_tensor(jax_run['qc']),
               qvel=torch.as_tensor(jax_run['vc']), time=torch.zeros(B))
    td = engine.forward(tm, ts, torch.as_tensor(jax_run['uc']))
    scale = np.abs(jd.efc_force).max()
    for name in ('qfrc_actuator', 'qfrc_passive'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   getattr(jd, name), err_msg=name,
                                   **STEP_TOL)
    for name in ('efc_force', 'qfrc_constraint', 'contact_force'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   getattr(jd, name), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=name)
    # qacc = M^-1 (...): the near-massless fingers scale it up to ~4e5
    np.testing.assert_allclose(td.qacc.numpy(), jd.qacc, rtol=1e-3,
                               atol=1e-3 * np.abs(jd.qacc).max())
    # the equality row carries force
    assert np.abs(jd.efc_force[:, 0]).max() > 1e-3
    touch = torch.expm1(manipulator.touch(tm, td))
    np.testing.assert_allclose(touch.numpy(), jtouch, rtol=1e-3,
                               atol=1e-5 * max(jtouch.max(), 1.0))


def test_apgd_plain_452_rows_matches_jax(tm_jiw, jax_run):
    """#1's plain twin on the cold and warm 452-row solves of two
    substeps from the contact poses, the equality row polished, against
    JAX's vmapped XLA iterate (the dense regime at any row count once an
    equality row is present; #1's global path on the card)."""
    ts = State(qpos=torch.as_tensor(jax_run['qc']),
               qvel=torch.as_tensor(jax_run['vc']), time=torch.zeros(B))
    captured = capture_solves(tm_jiw, ts, torch.as_tensor(jax_run['uc']))
    assert [kw['cold'] for _, kw in captured] == [True, False]
    assert apgd_solve.dense_route(NR) == 'global'
    for args, kw in captured:
        assert args[0].shape == (B, NR, NR)
        assert (kw['eq_rows'], kw['nonneg'], kw['con0'],
                kw['iterations']) == ((0,), tuple(range(1, 8)), CONE_ROWS,
                                      60)
        act = args[4]
        # Ad is zero in every inactive row and column (the global path
        # reads only the active submatrix)
        off = 1.0 - act[:, :, None] * act[:, None, :]
        assert float(np.abs(args[0] * off).max()) == 0.0
        f, v, its = apgd_solve.apgd_iterate_batched(
            *[torch.as_tensor(a) for a in args], return_iterations=True,
            **kw)
        ref = jax_iterate(args, kw)
        np.testing.assert_allclose(f.numpy(), ref[0], **APGD_TOL)
        np.testing.assert_allclose(v.numpy(), ref[1], **APGD_TOL)
        assert np.abs(ref[0][:, 0]).max() > 1e-3
        assert int(its.max()) > 5


def test_kinematics_with_per_env_body_poses(port_env, jax_run):
    """The target body moved and turned per env (``body_pos`` /
    ``body_quat`` of ``apply_params``): its shared quaternion is the
    identity, so the shared model's fast path would skip the product."""
    tm = port_env.model
    target = tm.name2id('body', 'target_ball')
    assert smooth.tree_meta(tm).identity_body_quat[target]
    moved = BRING_BALL.apply_params(
        tm, torch.as_tensor(jax_run['kin_params']))
    assert moved.body_quat.shape == (B, tm.nbody, 4)
    kin = smooth.kinematics(moved, torch.as_tensor(jax_run['qc']),
                            smooth.tree_meta(moved))
    for ours, ref, name in zip(kin[:6], jax_run['kin'],
                               ('xpos', 'xquat', 'xmat', 'geom_xpos',
                                'geom_xmat', 'site_xpos')):
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name,
                                   **PHYS_TOL)
    # the pose is the params'
    np.testing.assert_allclose(kin[0][:, target][:, [0, 2]].numpy(),
                               jax_run['kin_params'][:, :2], **PHYS_TOL)
    assert float((kin[1][:, target] - torch.tensor([1., 0, 0, 0])).abs()
                 .max()) > 1e-2


def test_reset_rejection_rule_on_jax_attempts(port_env, jax_run):
    """``first_collision_free_index`` on JAX's own eight draws an env
    (arm, ball and target placement) flags the same penetrating draws as
    JAX's detect and picks the attempt JAX picked."""
    qposes, params, penet = jax_run['attempts']        # (B, A, ...)
    tm = port_env.model
    att = torch.as_tensor(np.transpose(qposes, (1, 0, 2)).copy())
    kin = smooth.kinematics(tm, att.reshape(-1, tm.nq), smooth.tree_meta(tm))
    dist = collision.detect(tm, kin[3], kin[4],
                            collision.candidate_pairs(tm)).dist
    pen = (dist < 0).any(1).reshape(att.shape[:2]).numpy()
    np.testing.assert_array_equal(pen, penet.T)
    assert penet.any() and not penet.all()
    idx = randomizers.first_collision_free_index(tm, att).numpy()
    envs_ = np.arange(B)
    np.testing.assert_array_equal(qposes[envs_, idx],
                                  jax_run['phys'].qpos)
    np.testing.assert_array_equal(params[envs_, idx], jax_run['params'])


@pytest.mark.skipif(not HEAVY, reason='the JAX control step compiles 3 '
                    'forwards with 452-row solves, ~2 min on one core; '
                    'RUN_HEAVY=1')
def test_control_step_from_jax_reset_matches(port_env, jax_run):
    """One control step (10 substeps, 11 solves with the observation's)
    from the JAX-drawn episode inits with numpy actions: qpos, qvel,
    reward, the observation and the Manipulator wrapper's featured
    state."""
    jenv = jenv_of('manipulator', 'bring_ball')
    jwrap = jax_wrapper(jenv)
    acts = np.random.RandomState(3).uniform(-1, 1, (B, 5)).astype(
        np.float32)

    def one(phys, params, a):
        state0, obs0 = jax_env_state(jenv, phys, params)
        s1, ts1, d1 = jenv.step_with_data(state0, a)
        return state0, obs0, s1, ts1, jwrap.get_state(s1, d1)

    phys = JM.State(qpos=jnp.asarray(jax_run['phys'].qpos),
                    qvel=jnp.asarray(jax_run['phys'].qvel),
                    time=jnp.asarray(jax_run['phys'].time))
    with jax.default_matmul_precision('highest'):
        out = jax.jit(jax.vmap(one))(phys, jnp.asarray(jax_run['params']),
                                     acts)
    state0, obs0, j1, jts1, feat1 = jax.tree_util.tree_map(np.asarray, out)
    s = _port_state(state0)
    assert s.params.shape == (B, 3)
    _, ts0 = port_env.start(s.physics, s.params)
    for k, v in ts0.observation.items():
        np.testing.assert_allclose(v.numpy(), obs0[k], err_msg=k,
                                   **STEP_TOL)
    s1, ts, data = port_env.step_with_data(s, torch.as_tensor(acts))
    for ours, ref, name in ((s1.physics.qpos, j1.physics.qpos, 'qpos'),
                            (s1.physics.qvel, j1.physics.qvel, 'qvel'),
                            (ts.reward, jts1.reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name,
                                   **STEP_TOL)
    assert list(ts.observation) == sorted(jts1.observation)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), jts1.observation[k],
                                   err_msg=k, **STEP_TOL)
    w = envs.load('manipulator', 'bring_ball', device='cpu')
    np.testing.assert_allclose(w.get_state(s1, data).numpy(), feat1,
                               **STEP_TOL)


def test_wrapper_matches_jax(tm_jiw, jax_run):
    """The featured state (qpos, qvel, the grasp site's x and z, the five
    log1p touches read from the solve) of both wrappers on the same
    Data, the port's forward on the contact poses (rtol = atol = 1e-5);
    dims, goal weights and goal."""
    w = envs.load('manipulator', 'bring_ball', device='cpu')
    jw = jax_run['jwrap']
    ts = State(qpos=torch.as_tensor(jax_run['qc']),
               qvel=torch.as_tensor(jax_run['vc']), time=torch.zeros(B))
    td = engine.forward(tm_jiw, ts, torch.as_tensor(jax_run['uc']))
    feat = w.get_state(SimpleNamespace(physics=ts), td).numpy()
    fields = ('site_xpos', 'ximat', 'contact_pos', 'contact_dist',
              'contact_force')
    jfeat = np.asarray(jax.jit(jax.vmap(
        lambda q, v, d: jw.get_state(
            SimpleNamespace(physics=JM.State(qpos=q, qvel=v,
                                             time=jnp.zeros(()))),
            SimpleNamespace(**d))))(
        jax_run['qc'], jax_run['vc'],
        {f: getattr(td, f).numpy() for f in fields}))
    np.testing.assert_allclose(feat, jfeat, **PHYS_TOL)
    assert np.abs(feat[:, -5:]).max() > 0           # a touch reads force
    assert (w.state_dim, w.action_dim) == (jw.state_dim, jw.action_dim) == (
        29, 5)
    assert w.observation_dim == 44
    np.testing.assert_array_equal(w.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    g = w.set_goal(torch.Generator().manual_seed(0)).numpy()
    jg = np.asarray(jw.set_goal(jax.random.PRNGKey(0)))
    for x in (g, jg):
        assert x.shape == (29,) and (np.abs(x[8:10]) <= .4).all()
        np.testing.assert_array_equal(x[8:10], x[-7:-5])
        np.testing.assert_array_equal(x[-5:], 0.5)
        assert not x[:8].any() and not x[10:-7].any()


@pytest.mark.parametrize('task', TASKS)
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('manipulator', task,
                          suite.load('manipulator', task, device='cpu').model,
                          *HEAVY_THRESHOLDS[('manipulator', task)])


def test_agent_loop_on_cpu(tmp_path):
    """A tiny GoalStateAgent loop on the Manipulator wrapper: the batched
    CEM over the 29-dim featured state, one fit."""
    from mujoco_mbrl_tpu_torch import agents, data, models, planners
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.utils import MetricsWriter

    env = envs.load('manipulator', 'bring_ball', device='cpu')
    T = 2
    writer = MetricsWriter(str(tmp_path))
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner,
        model=models.MLPDynamics(29, 5, hidden_units=8), horizon=3,
        optimizer=Mt.adam(0.01), rollout_length=T,
        num_rollouts_per_iteration=2, num_train_iterations=1, writer=writer,
        base_path=str(tmp_path),
        dataset=data.init_replay(4, T, 29, env.observation_dim, 5,
                                 device='cpu'),
        planner_kwargs=dict(num_candidates=20, num_elites=4,
                            num_iterations=2),
        train_epochs=1, train_batch_size=4, num_initial_rollouts=2, seed=0)
    assert not agent.obs_only and agent.plan_dim == 29
    agent.train()
    writer.close()
    buf = agent.dataset
    assert buf.filled == 4 and buf.states.shape[-1] == 29
    assert bool(torch.isfinite(buf.states[:buf.filled]).all())


def test_cli_fails_where_jax_does(tmp_path):
    """The CLI's --environment splits at its last underscore, as JAX's
    does, so 'manipulator_bring_ball' names the wrapper
    'manipulator_bring', which neither package has: both fail loading it
    (JAX with a NameError, the port with its NotImplementedError for a
    wrapper it lacks); ``envs.load('manipulator', 'bring_ball')`` reaches
    the Manipulator wrapper."""
    from mujoco_mbrl_tpu import experiment as jexperiment
    from mujoco_mbrl_tpu_torch import experiment
    with pytest.raises(NameError, match='manipulator_bring'):
        jexperiment.Environment('manipulator_bring_ball')
    with pytest.raises(NotImplementedError, match='manipulator_bring'):
        experiment.main(experiment.parse_args([
            '--exp_dir', str(tmp_path), '--environment',
            'manipulator_bring_ball', '--device', 'cpu']))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    for task in TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load('manipulator', task)
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('manipulator', 'bring_ball')
