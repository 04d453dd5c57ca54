"""finger (elliptic cones, a friction-loss row, 39 constraint rows), port
against the JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B = 4; the JAX forward and episodes compile once, module
scoped):

* ``_XML`` is the JAX module's, and the compiled models of the three
  tasks match field by field (rtol 1e-5): the elliptic cone, impratio,
  the 200 solver iterations, the spinner's friction loss, the two
  decoration cylinders' masses and inertias, spin's hinge damping;
* on poses with the fingertip in the spinner and a hinge past its limit:
  kinematics with ``site_xpos`` (rtol = atol = 1e-5), the 39 constraint
  rows in JAX's order (1 friction-loss box row, 2 hinge limits, 12
  elliptic cone triples; the block list, J, aref, R, active, mu and the
  box bound at rtol 1e-5), the solve's forces (rtol 1e-4) and the two
  touch sensors read from the cone rows (rtol 1e-4);
* #1's plain twin with per-env box bounds (B, 39), on the cold and warm
  solves the port's own substeps build at those poses, against JAX's
  vmapped XLA iterate (``_apgd_dispatch(...).impl_fn``, the path JAX
  takes for finger since its kernel refuses batched bounds) to the
  400-iteration cap (rtol = atol = 2e-4);
* one control step of each task (2 substeps and the observation's
  forward) from JAX-drawn resets with numpy actions, Turn's per-env
  target included: qpos, qvel, reward and observation (atol = rtol =
  1e-4);
* the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py THRESHOLDS (35 / 40 steps at 1e-3);
* the reset's rejection rule and target circle, and that the entry
  points default to the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import finger as jfinger
from mujoco_mbrl_tpu.suite import sensors as jsensors
from mujoco_mbrl_tpu_torch import suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import finger, sensors
from test_parity_physics import THRESHOLDS
from test_torch_cartpole import (APGD_TOL, B, PHYS_TOL, STEP_TOL,
                                 assert_model_matches, jenv_of,
                                 tracks_mujoco_fixture)
from test_torch_contact_free import _port_state

TASKS = ('spin', 'turn_easy', 'turn_hard')
CONE_ROWS = tuple(range(3, 39, 3))


def jax_per_env_iterate(args, kw):
    """JAX's iterate on per-env bounds: the vmapped XLA ``impl`` of
    ``_apgd_dispatch``, mu (nr,) shared and bounds (B, nr) batched."""
    cv = jsolver._apgd_dispatch(kw['nonneg'], kw['box_rows'], kw['con0'],
                                kw['iterations'], kw['cold'], kw['eq_rows'])
    fn = jax.jit(jax.vmap(cv.impl_fn, in_axes=(0, 0, 0, 0, 0, None, 0)))
    with jax.default_matmul_precision('highest'):
        return [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]


def capture_solves(tm, state, ctrl, n_substeps=2):
    """The dense solves of ``n_substeps`` warm-started substeps:
    [(args as numpy, kwargs)] of each ``apgd_iterate_batched`` call."""
    captured, real = [], apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_batched = capture
    try:
        s, f, v = engine.step_warm(tm, state, ctrl)
        for _ in range(n_substeps - 1):
            s, f, v = engine.step_warm(tm, s, ctrl, warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_batched = real
    return captured


def test_finger_xml_is_a_copy():
    assert finger._XML == jfinger._XML


@pytest.mark.parametrize('task', TASKS)
def test_model_matches_jax_field_by_field(task):
    jm = jenv_of('finger', task).model
    tm = suite.load('finger', task, device='cpu').model
    assert_model_matches(jm, tm)
    assert (tm.opt.cone, tm.opt.impratio, tm.opt.solver_iterations) == (
        'elliptic', 1.0, 200)
    np.testing.assert_array_equal(tm.dof_frictionloss.numpy(),
                                  np.float32([0, 0, .1]))
    cyl = [g for g in range(tm.ngeom) if tm.geom_type[g] == M.CYLINDER]
    assert [tm.geom_body[g] for g in cyl] == [
        tm.name2id('body', 'proximal'), tm.name2id('body', 'spinner')]
    # each decoration cylinder carries its mass: proximal = cylinder
    # (r .034, half-length .033) + capsule (r .03, half-length .085)
    r, h = .034, .033
    cyl_mass = 1000 * np.pi * r * r * 2 * h
    cap_mass = 1000 * (np.pi * .03 ** 2 * .17 + 4 / 3 * np.pi * .03 ** 3)
    np.testing.assert_allclose(
        float(tm.body_mass[tm.name2id('body', 'proximal')]),
        cyl_mass + cap_mass, rtol=1e-6)
    hinge = tm.jnt_dofadr[tm.name2id('joint', 'hinge')]
    assert float(tm.dof_damping[hinge]) == pytest.approx(
        .03 if task == 'spin' else .5)
    assert tm.site_type[tm.name2id('site', 'touchtop')] == M.ELLIPSOID


def contact_poses(tm, n, seed):
    """Poses with fingertip-spinner contacts penetrating, half of them
    inside a touch site, the last env's proximal hinge past its limit and
    moving into it, small random finger velocities, a spinner fast enough
    to saturate its friction-loss row, and random controls."""
    rng = np.random.RandomState(seed)
    N = 4000
    q = np.stack([rng.uniform(-1.92, 1.92, N), rng.uniform(-1.92, 1.92, N),
                  rng.uniform(-np.pi, np.pi, N)], 1).astype(np.float32)
    kin = smooth.kinematics(tm, torch.as_tensor(q), smooth.tree_meta(tm))
    con = collision.detect(tm, kin[3], kin[4], collision.candidate_pairs(tm))
    dist = con.dist.numpy()
    hit = ((dist < 0) & (dist > -0.01)).any(1)
    # contacts inside a touch site's ellipsoid (the sites sit unrotated
    # in the distal body's frame)
    inside = np.zeros(N, bool)
    distal = tm.name2id('body', 'distal')
    for site in ('touchtop', 'touchbottom'):
        sid = tm.name2id('site', site)
        p = torch.einsum('nci,nij->ncj', con.pos - kin[5][:, sid, None],
                         kin[2][:, distal]).numpy()
        inside |= (((p / tm.site_size[sid].numpy()) ** 2).sum(-1) <= 1
                   ).any(1)
    touching = np.nonzero(hit & inside)[0][:n // 2]
    pick = np.concatenate([touching, np.nonzero(hit & ~inside)[0]])[:n]
    qpos = q[pick]
    qpos[-1, 0] = 1.95
    qvel = rng.normal(0.0, 0.2, (n, 3)).astype(np.float32)
    qvel[:, 2] = rng.normal(0.0, 2.0, n)
    qvel[-1, 0] = 0.5                   # into the limit, pushed there
    ctrl = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    ctrl[-1, 0] = 1.0
    return qpos, qvel, ctrl


@pytest.fixture(scope='module')
def forward_pair():
    """JAX and port forward passes on B poses in contact, with JAX's
    constraint rows, block list and touch sensors."""
    jm = jenv_of('finger', 'turn_hard').model
    tm = suite.load('finger', 'turn_hard', device='cpu').model
    qpos, qvel, ctrl = contact_poses(tm, B, seed=0)
    meta_box = []
    top, bot = (jm.name2id('site', s) for s in ('touchtop', 'touchbottom'))

    def jfwd(q, v, u):
        meta = jsmooth.tree_meta(jm)
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(())),
                            u)
        con = jcollision.detect(jm, d.geom_xpos, d.geom_xmat,
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, meta, q, v, d.cdof, con,
                              site_xpos=d.site_xpos)
        meta_box[:] = [cs.blocks]
        touch = jnp.stack([jsensors.touch(jm, d, top),
                           jsensors.touch(jm, d, bot)])
        return d, (cs.J, cs.aref, cs.R, cs.active, cs.mu), touch

    with jax.default_matmul_precision('highest'):
        jd, jrows, jtouch = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    ts = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
               time=torch.zeros(B))
    return dict(jm=jm, tm=tm, jd=jd, jrows=[np.asarray(x) for x in jrows],
                jtouch=np.asarray(jtouch), blocks=meta_box[0], ts=ts, ctrl=torch.as_tensor(ctrl),
                td=engine.forward(tm, ts, torch.as_tensor(ctrl)))


def test_kinematics_and_sites_match_jax(forward_pair):
    jd, td = forward_pair['jd'], forward_pair['td']
    for name in ('xpos', 'ximat', 'xipos', 'site_xpos', 'geom_xpos', 'cvel',
                 'qM', 'qfrc_bias', 'qfrc_passive', 'contact_dist',
                 'contact_pos'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   err_msg=name, **PHYS_TOL)


def test_39_rows_in_jax_order(forward_pair):
    """1 friction-loss row, 2 hinge limits, then 12 contact points (4
    plane-capsule pairs of 2, 4 capsule pairs of 1) as cone triples."""
    tm, jm = forward_pair['tm'], forward_pair['jm']
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(jm) and len(pairs) == 8
    assert len(sensors.contact_layout(tm)) == 12
    td, ts = forward_pair['td'], forward_pair['ts']
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat, pairs)
    cs = solver.assemble(tm, smooth.tree_meta(tm), ts.qpos, ts.qvel,
                         td.cdof, con, site_xpos=td.site_xpos)
    assert cs.J.shape == (B, 39, 3)
    assert cs.blocks == forward_pair['blocks']
    assert [k for k, _ in cs.blocks] == (['friction'] + ['limit'] * 2
                                         + ['contact'] * 12)
    assert [i for k, i in cs.blocks if k == 'contact'] == list(CONE_ROWS)
    jJ, jaref, jR, jact, jmu = forward_pair['jrows']
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               (jJ, jaref, jR, jact),
                               ('J', 'aref', 'R', 'active')):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    np.testing.assert_allclose(cs.mu.numpy(), jmu[0], rtol=1e-6)
    # JAX's box bound is the dof's frictionloss
    np.testing.assert_array_equal(cs.friction_bounds.numpy(),
                                  np.asarray(jm.dof_frictionloss)[[2]])
    act = cs.active.numpy()
    assert act[:, 0].all() and act[:, 1:3].sum() >= 1
    assert act[:, 3:].sum() >= 3 * B, act.sum(0)


def test_solve_and_touch_match_jax(forward_pair):
    """The forward's solve (rtol 1e-4) and the touchtop / touchbottom
    sensors read from the cone rows (rtol 1e-4)."""
    jd, td = forward_pair['jd'], forward_pair['td']
    f_ref = np.asarray(jd.efc_force)
    scale = np.abs(f_ref).max()
    for name in ('efc_force', 'qfrc_constraint', 'contact_force', 'qacc'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    # the friction-loss row sits on its bound in some env
    bound = float(forward_pair['tm'].dof_frictionloss[2])
    assert np.isclose(np.abs(f_ref[:, 0]), bound, rtol=1e-4).any(), f_ref[:, 0]
    tm = forward_pair['tm']
    touch = torch.stack([sensors.touch(tm, td, tm.name2id('site', s))
                         for s in ('touchtop', 'touchbottom')], 1)
    ref = forward_pair['jtouch']
    assert (ref > 1e-3).sum() >= 2, ref
    np.testing.assert_allclose(touch.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * ref.max())


def test_apgd_plain_per_env_bounds_matches_jax(forward_pair):
    """#1's plain twin on the cold and warm 39-row solves of two substeps
    from the contact poses, with per-env box bounds (B, 39), against
    JAX's vmapped XLA iterate to the 400-iteration cap."""
    captured = capture_solves(forward_pair['tm'], forward_pair['ts'],
                              forward_pair['ctrl'])
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape == (B, 39, 39) and args[6].shape == (B, 39)
        assert kw['box_rows'] == (0,) and kw['con0'] == CONE_ROWS
        assert kw['nonneg'] == (1, 2) and kw['iterations'] == 400
        # the bound over the row's scale: the spinner's inertia does not
        # change with the pose, so finger's envs share one value; the
        # second case gives each env its own
        bounds = args[6][:, 0]
        assert (bounds > 0.1).all()
        varied = args[:6] + (args[6] * np.float32(
            [[0.5], [1.0], [1.5], [2.0]]),)
        for case in (args, varied):
            f, v, its = apgd_solve.apgd_iterate_batched(
                *[torch.as_tensor(a) for a in case], return_iterations=True,
                **kw)
            ref = jax_per_env_iterate(case, kw)
            np.testing.assert_allclose(f.numpy(), ref[0], **APGD_TOL)
            np.testing.assert_allclose(v.numpy(), ref[1], **APGD_TOL)
            assert float(np.abs(f.numpy()).max()) > 1e-2
            assert int(its.max()) > 10
        # some env's friction-loss row sits on its (varied) bound
        assert np.isclose(np.abs(f.numpy()[:, 0]), varied[6][:, 0],
                          rtol=1e-5).any()


@pytest.fixture(scope='module')
def jax_episodes():
    """Per task: JAX-drawn resets (with Turn's target) and one control
    step of numpy actions."""
    acts = np.random.RandomState(2).uniform(-1, 1, (B, 2)).astype(
        np.float32)
    out = {}
    for task in TASKS:
        jenv = jenv_of('finger', task)

        def episode(k, a, jenv=jenv):
            s0, ts0 = jenv.reset(k)
            s1, ts1 = jenv.step(s0, a)
            return s0, ts0, s1, ts1

        keys = jax.random.split(jax.random.PRNGKey(5), B)
        out[task] = jax.jit(jax.vmap(episode))(keys, acts)
    return acts, out


@pytest.mark.parametrize('task', TASKS)
def test_control_step_from_jax_reset_matches(task, jax_episodes):
    acts, episodes = jax_episodes
    j0, jts0, j1, jts1 = episodes[task]
    env = suite.load('finger', task, device='cpu')
    assert env._n_sub_steps == 2
    s = _port_state(j0)
    if task != 'spin':
        assert s.params.shape == (B, 2)
    _, ts0 = env.start(s.physics, s.params)
    for k, v in ts0.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts0.observation[k]),
                                   err_msg=k, **STEP_TOL)
    s1, ts = env.step(s, torch.as_tensor(acts))
    for ours, ref, name in ((s1.physics.qpos, j1.physics.qpos, 'qpos'),
                            (s1.physics.qvel, j1.physics.qvel, 'qvel'),
                            (ts.reward, jts1.reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   err_msg=name, **STEP_TOL)
    assert list(ts.observation) == sorted(jts1.observation)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts1.observation[k]),
                                   err_msg=k, **STEP_TOL)


@pytest.mark.parametrize('task', TASKS)
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('finger', task,
                          suite.load('finger', task, device='cpu').model,
                          *THRESHOLDS[('finger', task)])


def test_reset_is_collision_free_with_the_target_on_its_circle():
    env = suite.load('finger', 'turn_hard', device='cpu')
    m = env.model
    state, ts = env.reset(64, torch.Generator().manual_seed(0))
    kin = smooth.kinematics(m, state.physics.qpos, smooth.tree_meta(m))
    dist = collision.detect(m, kin[3], kin[4],
                            collision.candidate_pairs(m)).dist
    assert not bool((dist < 0).any())
    np.testing.assert_allclose(
        torch.linalg.vector_norm(ts.observation['target_position'],
                                 dim=1).numpy(), 0.13, rtol=1e-5)
    lo, hi = m.jnt_range[0].tolist()
    q = state.physics.qpos
    assert bool(((q[:, :2] >= lo) & (q[:, :2] <= hi)).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    for task in TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load('finger', task)
