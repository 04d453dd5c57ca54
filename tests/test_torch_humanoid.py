"""The humanoid slice, port against the JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B <= 4; the JAX humanoid compiles once per fixture, module
scoped):

* ``_XML`` is the JAX module's, and the compiled model matches field by
  field (rtol 1e-5), the free joint's ``dof_invweight0`` and
  ``body_invweight0`` (which set R on every row), ``jnt_stiffness``,
  ``dof_armature`` and the per-geom condim named;
* kinematics, cdof, cdof_dot, the mass matrix, bias and passive forces
  and the subtree sensors on random unit-quaternion ``qpos`` (rtol = atol
  = 1e-5 of each field's scale);
* ``integrate_pos`` with the free joint's quaternion, and the quaternion
  helpers it rests on (atol 1e-6);
* the three new pair kernels (plane-sphere, sphere-sphere,
  sphere-capsule; atol 1e-5), and ``detect`` on poses in contact, rows in
  candidate order over the five type groups (atol 1e-5);
* the 303 constraint rows: their order and row types (JAX's block list)
  and J / aref / R / active (rtol 1e-5); the factored solve inside the
  step (rtol 1e-4), and the plain factored iterate against the JAX XLA
  iterate on solves captured from the port (rtol = atol = 2e-4, as
  tests/test_torch_apgd_factored.py, on every env that converges; an env
  at the iteration cap on its dual objective, rtol 1e-6, and its
  joint-space force, 2e-4 of its largest entry);
* one control step from JAX-drawn resets (those picks): qpos, qvel, reward,
  observation and the wrapper's featured state (atol 1e-4, the step
  tolerance of tests/test_torch_cheetah.py);
* the four MuJoCo parity fixtures in their CPU bands
  (tests/test_parity_physics.py THRESHOLDS);
* the reset's rejection rule on given attempts: on JAX's own draws, as
  drawn and with some sunk below the floor, the port picks what JAX's
  rule picks on JAX's contact distances;
* the wrapper (dims, goal weights, featured state, legs-only actions,
  state widths), ``bench.config('humanoid')`` and its route, and a tiny
  CLI run on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import make_state as jmake_state
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import humanoid as jhumanoid
from mujoco_mbrl_tpu.suite import randomizers as jrandomizers
from mujoco_mbrl_tpu.suite import sensors as jsensors
from mujoco_mbrl_tpu_torch import bench, convert, envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve, cem_mma
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import humanoid, sensors
from parity_utils import steps_within
from test_parity_physics import THRESHOLDS

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures', 'parity')
B = 4
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
APGD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope='module')
def jenv():
    return jsuite.load('humanoid', 'walk')


@pytest.fixture(scope='module')
def models(jenv):
    return jenv.model, suite.load('humanoid', 'walk', device='cpu').model


def _close(ours, ref, tol, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


def test_humanoid_xml_is_a_copy():
    assert humanoid._XML == jhumanoid._XML


def test_model_matches_jax_field_by_field(models):
    jm, tm = models
    assert (tm.nq, tm.nv, tm.nu, tm.nbody, tm.ngeom, tm.njnt) == (
        28, 27, 21, 17, 20, 22)
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
                 'cone', 'impratio', 'solver_warmstart',
                 'enable_geom_geom_contacts'):
        assert getattr(tm.opt, name) == getattr(jm.opt, name), name
    # the fields that set R on every row, and the class tree's values
    assert tm.jnt_type[0] == M.FREE and tm.jnt_qposadr[:2] == (0, 7)
    iw = tm.dof_invweight0.numpy()
    assert np.ptp(iw[0:3]) == 0.0 and np.ptp(iw[3:6]) == 0.0
    for name in ('dof_invweight0', 'body_invweight0', 'jnt_stiffness',
                 'dof_armature', 'qpos0'):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    q = tm.qpos0.numpy()
    np.testing.assert_allclose(q[:7], [0, 0, 1.5, 1, 0, 0, 0])
    assert float(tm.jnt_stiffness[0]) == 0.0      # the free joint: no class
    assert float(tm.dof_armature[0]) == 0.0
    assert set(tm.dof_armature.numpy()[6:]) == {np.float32(0.01)}
    assert tm.geom_condim == (3,) + (1,) * 19
    np.testing.assert_allclose(tm.jnt_solimp[1, :3].numpy(), [0, .99, .01])
    np.testing.assert_allclose(tm.geom_solref[1].numpy(), [.015, 1])


def test_candidate_pairs_give_303_rows(models):
    jm, tm = models
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(jm)
    kinds = [(tm.geom_type[a], tm.geom_type[b]) for a, b in pairs]
    assert len(pairs) == 161
    for key, n in (((M.CAPSULE, M.CAPSULE), 100),
                   ((M.SPHERE, M.CAPSULE), 39), ((M.PLANE, M.CAPSULE), 16),
                   ((M.PLANE, M.SPHERE), 3), ((M.SPHERE, M.SPHERE), 3)):
        assert kinds.count(key) == n, key
    assert sum(collision._PAIR_POINTS[k] for k in kinds) == 177
    assert solver.factored_fits(303, 27)
    assert apgd_solve.factored_route(303, 27) == 'block'


def _poses(tm, n, seed, z=(0.2, 0.9)):
    """Humanoid configurations low enough to touch the floor, with random
    unit root quaternions, joints drawn a little past their ranges (some
    limit rows active), random velocities and controls."""
    rng = np.random.RandomState(seed)
    lo, hi = tm.jnt_range[1:, 0].numpy(), tm.jnt_range[1:, 1].numpy()
    qpos = np.tile(tm.qpos0.numpy(), (n, 1))
    qpos[:, :2] = rng.uniform(-1, 1, (n, 2))
    qpos[:, 2] = rng.uniform(*z, n)
    quat = rng.normal(size=(n, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] = lo + rng.uniform(-0.05, 1.05, (n, 21)) * (hi - lo)
    qvel = rng.normal(0.0, 1.0, (n, tm.nv))
    ctrl = rng.uniform(-1.0, 1.0, (n, tm.nu))
    return [x.astype(np.float32) for x in (qpos, qvel, ctrl)]


@pytest.fixture(scope='module')
def jax_attempts(jenv):
    """The JAX humanoid reset's eight rejection-sampling attempts per env
    (B, A, nq), drawn as its initialize_episode draws them from per-env
    keys."""
    jm, task = jenv.model, jenv._task
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return np.asarray(jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda kk: jrandomizers.randomize_limited_and_rotational_joints(
            jm, jnp.asarray(jm.qpos0), kk))(jax.random.split(
                k, task._INIT_ATTEMPTS))))(keys))


def _first_free(dist):
    """JAX's rule on contact distances (A, B, C) of the attempts: each
    env's first attempt without penetration, else attempt 0."""
    free = ~(dist < 0).any(-1)
    return np.where(free.any(0), free.argmax(0), 0)


@pytest.fixture(scope='module')
def jax_episode(jenv, jax_attempts, forward_pair):
    """JAX-drawn resets (the attempts picked by JAX's rule on JAX's own
    contact distances), one control step of numpy actions with its Data,
    and the JAX wrapper's featured state of it."""
    jm = jenv.model
    att = np.transpose(jax_attempts, (1, 0, 2))
    qpos0 = att[_first_free(forward_pair['att_dist_raw']), np.arange(B)]
    phys0 = jax.vmap(lambda q: jmake_state(jm, qpos=q))(qpos0)
    state0 = jsuite.EnvState(physics=phys0, params=(),
                             step_count=jnp.zeros((B,), jnp.int32),
                             last=jnp.zeros((B,), jnp.bool_))
    acts = np.random.RandomState(2).uniform(-1, 1, (B, 21)).astype(
        np.float32)
    jwrap = object.__new__(jenvs.wrappers.Humanoid)
    jwrap._env, jwrap._state_penalty = jenv, 1.0
    jwrap.action_dim = jm.nu

    def step(s, a):
        s1, ts, d = jenv.step_with_data(s, a)
        return s1, ts, jwrap.get_state(s1, d)

    s1, ts1, feat = jax.jit(jax.vmap(step))(state0, acts)
    return dict(state0=state0, acts=acts, state1=s1, ts1=ts1, feat1=feat,
                jwrap=jwrap)


SUNK = (0, 2, 5, 8)


def _sunk_attempts(attempts):
    """The JAX-drawn attempts (B, A, nq) as (A, B, nq), with env b's first
    SUNK[b] attempts dropped half a metre below the floor (the last env:
    all of them, so it falls back to attempt 0)."""
    att = np.transpose(attempts, (1, 0, 2)).copy()
    for b, k in enumerate(SUNK):
        att[:k, b, 2] = -0.5
    return att



@pytest.fixture(scope='module')
def forward_pair(models, jax_attempts):
    """JAX and port forward passes on B low poses (in contact; the same
    JAX call gives the contact distances of the reset attempts, as drawn
    and sunk), with JAX's constraint rows, block list and subtree
    sensors."""
    jm, tm = models
    qpos, qvel, ctrl = _poses(tm, B, seed=0)
    raw = np.transpose(jax_attempts, (1, 0, 2))
    att = _sunk_attempts(jax_attempts)
    A = att.shape[0]
    allq = np.concatenate([qpos, raw.reshape(A * B, tm.nq),
                           att.reshape(A * B, tm.nq)])
    n = allq.shape[0]
    allv = np.concatenate([qvel, np.zeros((n - B, tm.nv), np.float32)])
    allu = np.concatenate([ctrl, np.zeros((n - B, tm.nu), np.float32)])
    blocks = []
    torso = jm.name2id('body', 'torso')

    def jfwd(q, v, u):
        meta = jsmooth.tree_meta(jm)
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(())),
                            u)
        con = jcollision.detect(jm, d.geom_xpos, d.geom_xmat,
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, meta, q, v, d.cdof, con)
        blocks[:] = [cs.blocks]
        sens = (jsensors.subtree_com(jm, d, torso),
                jsensors.subtree_linvel(jm, d, torso))
        return d, (cs.J, cs.aref, cs.R, cs.active), sens

    with jax.default_matmul_precision('highest'):
        jd, jrows, jsens = jax.jit(jax.vmap(jfwd))(allq, allv, allu)
    dist = np.asarray(jd.contact_dist)[B:].reshape(2, A, B, -1)
    first = lambda x: np.asarray(x)[:B]
    ts = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
               time=torch.zeros(B))
    return dict(jd=jax.tree_util.tree_map(first, jd),
                jrows=tuple(first(x) for x in jrows),
                jsens=tuple(first(x) for x in jsens), blocks=blocks[0],
                td=engine.forward(tm, ts, torch.as_tensor(ctrl)), ts=ts,
                att=att, att_dist_raw=dist[0], att_dist=dist[1])


def test_kinematics_and_dynamics_match_jax(models, forward_pair):
    """Poses, cdof, velocities, the mass matrix, bias and passive forces
    and the subtree sensors on a floating base (rtol = atol = 1e-5 of
    each field's scale)."""
    jm, tm = models
    jd, td = forward_pair['jd'], forward_pair['td']
    for name in ('xpos', 'xquat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
                 'xanchor', 'xaxis', 'cdof', 'cvel', 'cdof_dot', 'qM',
                 'qfrc_bias', 'qfrc_passive', 'qfrc_actuator'):
        _close(getattr(td, name).numpy(), getattr(jd, name), 1e-5, name)
    torso = tm.name2id('body', 'torso')
    for ours, ref, name in zip(
            (sensors.subtree_com(tm, td, torso),
             sensors.subtree_linvel(tm, td, torso)),
            forward_pair['jsens'], ('subtree_com', 'subtree_linvel')):
        _close(ours.numpy(), ref, 1e-5, name)
    # the root quaternions are random: the body frames really rotate
    assert float(td.ximat[:, 1, 2, 2].abs().min()) < 0.99


def test_integrate_pos_matches_jax(models):
    jm, tm = models
    qpos, _, _ = _poses(tm, B, seed=3)
    rng = np.random.RandomState(3)
    qvel = rng.normal(0, 3, (B, tm.nv)).astype(np.float32)
    qvel[0, 3:6] = 0.0                  # a resting root: the x-axis branch
    h = float(tm.opt.timestep)
    ref = jax.jit(jax.vmap(lambda q, v: jengine.integrate_pos(
        jm, q, v, jnp.float32(h))))(qpos, qvel)
    ours = engine.integrate_pos(tm, torch.as_tensor(qpos),
                                torch.as_tensor(qvel), h)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(ours[:, 3:7].numpy(), axis=1), 1.0, atol=1e-6)


def test_quaternion_helpers_match_jax():
    """quat_conj, quat_rot_inv, axis_angle_quat, quat_integrate (a zero
    velocity among them) and quat_normalize on random inputs, against the
    JAX functions under vmap (atol 1e-6)."""
    from mujoco_mbrl_tpu.physics import math as jpm
    from mujoco_mbrl_tpu_torch.physics import math as pm
    rng = np.random.RandomState(7)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    w = rng.normal(scale=3.0, size=(16, 3)).astype(np.float32)
    w[0] = 0.0
    axis = v / np.linalg.norm(v, axis=1, keepdims=True)
    ang = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = torch.as_tensor
    for ours, ref in (
            (pm.quat_conj(t(q)), jax.vmap(jpm.quat_conj)(q)),
            (pm.quat_normalize(t(q)), jax.vmap(jpm.quat_normalize)(q)),
            (pm.quat_rot_inv(t(qn), t(v)), jax.vmap(jpm.quat_rot_inv)(qn, v)),
            (pm.axis_angle_quat(t(axis), t(ang)),
             jax.vmap(jpm.axis_angle_quat)(axis, ang)),
            (pm.quat_integrate(t(qn), t(w), 0.005), jax.vmap(
                lambda a, b: jpm.quat_integrate(a, b, jnp.float32(0.005)))(
                    qn, w))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize('kernel', ['_k_plane_sphere', '_k_sphere_sphere',
                                    '_k_sphere_capsule'])
def test_pair_kernel_matches_jax(kernel):
    """Random frames, centres and sizes (capsule half-lengths 0.05-0.3,
    radii 0.02-0.1), half of them overlapping, against the JAX per-pair
    kernel under vmap (atol 1e-5)."""
    rng = np.random.RandomState(len(kernel))
    n = 64
    quat = rng.normal(size=(2, n, 4))
    quat /= np.linalg.norm(quat, axis=2, keepdims=True)
    R = np.stack([np.asarray(jax.vmap(jsmooth.pm.quat_to_mat)(q))
                  for q in quat], 1).astype(np.float32)       # (n, 2, 3, 3)
    ctr = rng.normal(scale=0.15, size=(n, 2, 3)).astype(np.float32)
    size = np.zeros((n, 2, 3), np.float32)
    size[..., 0] = rng.uniform(0.02, 0.1, (n, 2))
    size[..., 1] = rng.uniform(0.05, 0.3, (n, 2))
    ref = jax.vmap(getattr(jcollision, kernel))(
        ctr[:, 0], R[:, 0], size[:, 0], ctr[:, 1], R[:, 1], size[:, 1])
    t = lambda x: torch.as_tensor(x)
    ours = getattr(collision, kernel)(
        t(ctr[None, :, 0]), t(R[None, :, 0]), t(size[:, 0]),
        t(ctr[None, :, 1]), t(R[None, :, 1]), t(size[:, 1]))
    for o, r, name in zip(ours, ref, ('dist', 'pos', 'normal')):
        np.testing.assert_allclose(o[0].numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)
    d = np.asarray(ref[0])
    assert (d < 0).any() and (d > 0).any()


def test_detect_matches_jax_in_contact(models, forward_pair):
    """The whole detect on JAX's own kinematics of poses in contact: 177
    rows in candidate order across the five type groups (atol 1e-5)."""
    jm, tm = models
    jd = forward_pair['jd']
    pairs = collision.candidate_pairs(tm)
    con = collision.detect(tm, torch.tensor(np.array(jd.geom_xpos)),
                           torch.tensor(np.array(jd.geom_xmat)), pairs)
    for ours, name in ((con.dist, 'contact_dist'), (con.pos, 'contact_pos'),
                       (con.frame, 'contact_frame')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(getattr(jd, name)),
                                   atol=1e-5, err_msg=name)
    rows = np.repeat([(tm.geom_type[a], tm.geom_type[b]) for a, b in pairs],
                     [collision._PAIR_POINTS[(tm.geom_type[a],
                                              tm.geom_type[b])]
                      for a, b in pairs], axis=0)
    d = con.dist.numpy()
    floor = rows[:, 0] == M.PLANE
    assert (d[:, floor] < 0).any(), 'no floor contact exercised'
    assert (d[:, ~floor] < 0.02).any(), 'no geom pair close'
    assert con.dist.shape == (B, 177)


def test_constraint_rows_and_solve_match_jax(models, forward_pair):
    """The 303 rows in JAX's order and types: 21 limits, then the 142
    condim-1 geom-geom rows (non-negative, one a point), then the 35 floor
    pyramids of 4 facets; J, aref, R, active (rtol 1e-5); the factored
    solve of the forward (rtol 1e-4)."""
    jm, tm = models
    td, ts = forward_pair['td'], forward_pair['ts']
    meta = smooth.tree_meta(tm)
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat,
                           collision.candidate_pairs(tm))
    cs = solver.assemble(tm, meta, ts.qpos, ts.qvel, td.cdof, con)
    assert cs.J.shape == (B, 303, 27)
    assert cs.blocks == forward_pair['blocks']
    kinds = [k for k, _ in cs.blocks]
    assert kinds == ['limit'] * (21 + 142) + ['facet'] * 140
    assert [p[2] for p in cs.pyramids] == [0] * 142 + [2] * 35
    nonneg, box_rows, con0 = solver._row_structure(cs)
    assert len(nonneg) == 303 and not len(box_rows) and not len(con0)
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               forward_pair['jrows'],
                               ('J', 'aref', 'R', 'active')):
        _close(ours.numpy(), ref, 1e-5, name)
    jd = forward_pair['jd']
    f_ref = np.asarray(jd.efc_force)
    assert (np.abs(f_ref) > 1e-3).sum() > 10, 'too few active rows'
    scale = np.abs(f_ref).max()
    for name in ('efc_force', 'qfrc_constraint', 'contact_force', 'qacc'):
        ref = np.asarray(getattr(jd, name))
        np.testing.assert_allclose(getattr(td, name).numpy(), ref,
                                   rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_factored_plain_matches_jax_xla_iterate(models):
    """The port's plain factored iterate on the solves its own step builds
    at poses in contact (B = 4: a cold substep, then a warm one from its
    forces) against the JAX XLA iterate: v and the f of every env that
    converges within rtol = atol = 2e-4; the envs at the iteration cap
    through ``hold_at_cap``."""
    from mujoco_mbrl_tpu.physics import solver as jsolver_mod
    _, tm = models
    qpos, qvel, ctrl = _poses(tm, B, seed=5)
    captured = {}
    real = apgd_solve.apgd_iterate_factored

    def capture(*args, **kw):
        captured[kw['cold']] = ([a.numpy().copy() for a in args], dict(kw))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_factored = capture
    try:
        s = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
                  time=torch.zeros(B))
        s1, f, v = engine.step_warm(tm, s, torch.as_tensor(ctrl))
        engine.step_warm(tm, s1, torch.as_tensor(ctrl), warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_factored = real
    assert sorted(captured) == [False, True]
    for cold, ((*args, mu, bounds), kw) in sorted(captured.items()):
        nr = args[4].shape[1]
        assert args[0].shape == (B, 303, 27) and not kw['con0']
        cv = jsolver_mod._apgd_dispatch_factored(
            kw['nonneg'], (), (), kw['iterations'], cold)
        fn = jax.jit(lambda a: jax.vmap(cv)(*a, *[
            jnp.broadcast_to(jnp.asarray(x), (B, nr)) for x in (mu, bounds)]))
        with jax.default_matmul_precision('highest'):
            ref = [np.asarray(x) for x in fn(tuple(jnp.asarray(a)
                                                    for a in args))]
        f, v, its = apgd_solve.apgd_iterate_factored(
            *[torch.as_tensor(a) for a in args], torch.as_tensor(mu),
            torch.as_tensor(bounds), **kw, return_iterations=True)
        assert np.abs(ref[0]).max() > 1e-3, 'no force exercised'
        np.testing.assert_allclose(v.numpy(), ref[1], err_msg='v',
                                   **APGD_TOL)
        cap = (its == kw['iterations']).numpy()
        assert 0 < cap.sum() < B, 'no env at the cap, or none converged'
        np.testing.assert_allclose(f.numpy()[~cap], ref[0][~cap],
                                   err_msg='f', **APGD_TOL)
        hold_at_cap(args, f.numpy()[cap], ref[0][cap], cap)


def hold_at_cap(args, f, f_ref, cap):
    """Envs at the iteration cap: 303 rows over 27 dofs leave the dual a
    flat valley (strictly convex only through the small Rs), along which
    an unconverged iterate ends where rounding took it, so f is held
    through what the physics reads: the dual objective 1/2 f'Ad f - f'rhs
    to 1e-6 relative and the joint-space force J~' f to 2e-4 of its
    largest entry (the flat-valley test of chip_smoke.py hold_apgd). The
    JAX XLA iterate applies Ad formed in float32, whose rounding moves such
    envs; the port's plain iterate applies it in float64."""
    J, Minv, Rs = (np.asarray(a, np.float64)[cap] for a in args[:3])
    rhs = np.asarray(args[4], np.float64)[cap]
    Ad = J @ Minv @ J.transpose(0, 2, 1) + Rs[:, :, None] * np.eye(
        J.shape[1])
    phi = lambda x: (0.5 * np.einsum('br,brs,bs->b', x, Ad, x)
                     - (x * rhs).sum(1))
    f, f_ref = f.astype(np.float64), f_ref.astype(np.float64)
    np.testing.assert_allclose(phi(f), phi(f_ref), rtol=1e-6, atol=0)
    jf, jf_ref = (np.einsum('brv,br->bv', J, x) for x in (f, f_ref))
    scale = np.abs(jf_ref).max(1, keepdims=True)
    assert (np.abs(jf - jf_ref) <= 2e-4 * (1.0 + scale)).all()


def test_control_step_from_jax_reset_matches(jax_episode):
    """One control step (5 substeps, a cold then four warm solves) from
    JAX-drawn resets with numpy actions: state, reward, observation and
    the wrapper's featured state (atol = rtol = 1e-4)."""
    wrap = envs.load('humanoid', 'walk', device='cpu')
    env = wrap.env
    j0, j1 = jax_episode['state0'], jax_episode['state1']
    s = convert.env_state(j0.physics.qpos, j0.physics.qvel,
                          time=j0.physics.time)
    s1, ts, data = env.step_with_data(
        s, torch.as_tensor(jax_episode['acts']))
    np.testing.assert_allclose(s1.physics.qpos.numpy(),
                               np.asarray(j1.physics.qpos), err_msg='qpos',
                               **STEP_TOL)
    np.testing.assert_allclose(s1.physics.qvel.numpy(),
                               np.asarray(j1.physics.qvel), err_msg='qvel',
                               **STEP_TOL)
    jts = jax_episode['ts1']
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                               atol=1e-5)
    assert list(ts.observation) == sorted(jts.observation)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts.observation[k]),
                                   err_msg=k, **STEP_TOL)
    np.testing.assert_allclose(wrap.get_state(s1, data).numpy(),
                               np.asarray(jax_episode['feat1']), **STEP_TOL)


@pytest.mark.parametrize('task', ['stand', 'walk', 'run', 'run_pure_state'])
def test_tracks_mujoco_fixture(models, task):
    """The port alone from the oracle's post-reset state, the recorded
    ctrl held over the substeps, within the CPU band."""
    min_steps, tol = THRESHOLDS[('humanoid', task)]
    fix = np.load(os.path.join(FIXTURES, f'humanoid_{task}.npz'))
    m = models[1]
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


def test_reset_rejection_rule_on_given_attempts(models, jax_attempts,
                                                jax_episode, forward_pair):
    """``first_collision_free`` on JAX's own eight draws per env picks the
    attempts JAX's rule picks on JAX's contact distances (the resets the
    control step starts from); with env b's first SUNK[b] attempts sunk
    below the floor it takes the first attempt that JAX's detect finds
    free of penetration, and attempt 0 where none is."""
    _, tm = models
    att = np.transpose(jax_attempts, (1, 0, 2))
    ours = humanoid.first_collision_free(tm, torch.tensor(att))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_episode['state0'].physics.qpos))
    sunk = forward_pair['att']
    pen = (forward_pair['att_dist'] < 0).any(-1)          # (A, B)
    free = ~pen
    want = _first_free(forward_pair['att_dist'])
    for b, k in enumerate(SUNK):
        assert pen[:k, b].all()
    assert want[-1] == 0 and not free[:, -1].any()
    assert (want[:-1] >= np.array(SUNK[:-1])).all()
    got = humanoid.first_collision_free(tm, torch.as_tensor(sunk))
    np.testing.assert_array_equal(got.numpy(),
                                  sunk[want, np.arange(B)])


def test_reset_draws_unit_quaternions():
    """The port's own reset: unit root quaternions, joints in range, no
    penetration, the root at its qpos0 position."""
    env = suite.load('humanoid', 'stand', device='cpu')
    state, ts = env.reset(8, torch.Generator().manual_seed(0))
    q = state.physics.qpos
    np.testing.assert_allclose(torch.linalg.vector_norm(q[:, 3:7], dim=1),
                               1.0, atol=1e-6)
    assert float(q[:, :3].sub(torch.tensor([0, 0, 1.5])).abs().max()) == 0
    rng = env.model.jnt_range[1:]
    assert bool(((q[:, 7:] >= rng[:, 0]) & (q[:, 7:] <= rng[:, 1])).all())
    assert ts.observation['joint_angles'].shape == (8, 21)


def test_wrapper_matches_jax(jax_episode):
    wrap = envs.load('humanoid', 'walk', device='cpu')
    jwrap = jax_episode['jwrap']
    assert (wrap.state_dim, wrap.observation_dim, wrap.action_dim) == (
        jwrap.state_dim, jwrap.observation_dim, 21) == (60, 67, 21)
    np.testing.assert_array_equal(wrap.get_goal_weights().numpy(),
                                  np.asarray(jwrap.get_goal_weights()))
    np.testing.assert_array_equal(wrap.set_goal().numpy(), np.asarray(
        jwrap.set_goal(jax.random.PRNGKey(0))))
    feat = torch.as_tensor(np.asarray(jax_episode['feat1']))
    qpos, qvel = wrap.state_to_physics(feat)
    jq, jv = jwrap.state_to_physics(jnp.asarray(jax_episode['feat1'][0]))
    assert qpos.shape == (B, 28) and qvel.shape == (B, 27)
    np.testing.assert_array_equal(qpos[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(qvel[0].numpy(), np.asarray(jv))
    # legs-only Gaussian actions, std 0.4
    g = torch.Generator().manual_seed(0)
    a = wrap.sample_action(g, (4000,))
    ja = np.asarray(jwrap.sample_action(jax.random.PRNGKey(0), (4000,)))
    assert a.shape == ja.shape == (4000, 21)
    for x in (a.numpy(), ja):
        assert (x[:, 3:-6] == 0).all() and (x[:, :3] != 0).all()
        assert abs(x[:, :3].std() - 0.4) < 0.02
    st = wrap.sample_state(g, (3,))
    js = np.asarray(jwrap.sample_state(jax.random.PRNGKey(1)))
    assert st.shape == (3, 55) and js.shape == (55,)
    lo, hi = map(np.array, zip(*wrap._SAMPLE_RANGES))
    for x in (st.numpy(), js[None]):
        assert (x[:, 2] == np.float32(1.3)).all()
        assert ((x[:, 7:28] >= lo - 1e-6) & (x[:, 7:28] <= hi + 1e-6)).all()
        assert (np.delete(x, [2] + list(range(7, 28)), axis=1) == 0).all()


def test_bench_preset_and_route(monkeypatch):
    """bench.config('humanoid') is the JAX preset; 67 + 21 dims take the
    fused sampler (the tile layouts (11, 7, 9) at the bench's observation,
    (11, 7, 8) at the CLI's featured state); a tiny control step runs on
    the CPU."""
    cfg = bench.config('humanoid')
    assert cfg == dict(jbench.CONFIGS['humanoid'])
    assert 67 + 21 >= bench.FUSED_MIN_DIMS
    assert cem_mma.layout(67, 21, 50)[:3] == (11, 7, 9)
    assert cem_mma.layout(60, 21, 50)[:3] == (11, 7, 8)
    taken = []
    real = bench.mlp_sample_rollout_costs
    monkeypatch.setattr(bench, 'mlp_sample_rollout_costs', lambda *a, **k: (
        taken.append(a[2].shape), real(*a, **k))[1])
    run, (p, s, g) = bench.build_bench(cfg['task'], 2, 16, 3, 2, 1,
                                       device='cpu')
    state, rewards = run(p, s, g)
    assert taken == [(2, 67)] * 2
    assert state.physics.qpos.shape == (2, 28)
    assert bool(torch.isfinite(rewards).all())


def test_cli_runs_on_cpu(tmp_path):
    from mujoco_mbrl_tpu_torch import experiment
    agent = experiment.main(experiment.parse_args([
        '--exp_dir', str(tmp_path), '--environment', 'humanoid_walk',
        '--planner', 'cem', '--model', 'nn', '--rollout_length', '3',
        '--num_rollouts_per_iteration', '2', '--num_train_iterations', '1',
        '--train_epochs', '1', '--device', 'cpu', '--planner_kwargs',
        '{"num_candidates": 16, "num_elites": 4}']))
    assert agent.plan_dim == 60 and not agent.obs_only
    buf = agent.dataset
    assert buf.states.shape[-1] == 60
    assert bool(torch.isfinite(buf.states[:buf.filled]).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import experiment
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('humanoid', 'walk')
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('humanoid', 'walk')
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'humanoid_walk']))
    cfg = bench.config('humanoid')
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.build_bench(cfg['task'], 2, 8, 3, 1, 1)
