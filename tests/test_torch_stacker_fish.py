"""stacker (the four box pair kernels, 641 and 977 dense rows) and fish
(position servos: an affine bias; no constraint row), port against the
JAX package.

Same inputs, drawn with numpy from a seed or by the JAX reset, go through
both packages (B = 4):

* the stacker's props XML and fish's ``_XML`` are the JAX modules', and
  the compiled models of stack_2, stack_4 and both fish tasks match field
  by field (rtol 1e-5; the mj_setConst invweights at rtol 1e-3 of the
  float64 compile, as for the manipulator): the boxes, the servos' gain
  and bias parameters and types;
* each box pair kernel (plane-box, sphere-box, capsule-box, box-box)
  against JAX's on random poses in contact and apart: distances, points
  and contact frames (rtol = atol = 1e-5; a point whose distance ties
  another of its pair within 1e-6 is held by its distance only, its
  order being rounding's);
* ``detect`` on stack_2 poses in contact against JAX's (candidate order,
  each pair's points contiguous, rtol = atol = 1e-5);
* #1's plain twin on the cold and warm 641-row solves the port's own
  substeps build at those poses, against JAX's vmapped XLA iterate
  (rtol = atol = 2e-4);
* the port's stacker reset (collision-free, the target column's height
  a box size times 1, 3, 5 or 7) and, gated behind RUN_HEAVY=1 for its
  JAX compile, the rejection rule on JAX's own attempts and a control
  step from JAX-drawn resets;
* fish: the affine bias of ``actuation`` on joints and the fixed tendon
  against JAX's at random states and controls (rtol 1e-5), one control
  step of each task from JAX-drawn resets (swim's per-env target) at
  atol = rtol = 1e-4, and the MuJoCo parity fixtures of both domains
  within the CPU bands of tests/test_parity_physics.py (fish 100 steps,
  stacker 9, at 1e-3; port-only runs).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.suite import fish as jfish
from mujoco_mbrl_tpu.suite import stacker as jstacker
from mujoco_mbrl_tpu_torch import suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, smooth
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import fish, manipulator, randomizers
from mujoco_mbrl_tpu_torch.suite import stacker
from test_parity_physics import HEAVY_THRESHOLDS, THRESHOLDS
from test_torch_cartpole import (APGD_TOL, B, STEP_TOL, assert_model_matches,
                                 jenv_of, tracks_mujoco_fixture)
from test_torch_contact_free import _port_state
from test_torch_finger import capture_solves
from test_torch_manipulator import (INVWEIGHTS, assert_invweights_close,
                                    jax_env_state, jax_iterate,
                                    recording_init, with_jax_invweights)

HEAVY = os.environ.get('RUN_HEAVY', '') == '1'
STACKS = ('stack_2', 'stack_4')
N_PAIRS = 64


def _xml(task):
    return (manipulator._make_model_xml(
        props=stacker._props_xml(int(task[-1])), geom_solref='.01 1')
        if task.startswith('stack') else fish._XML)


def test_xml_is_a_copy():
    assert fish._XML == jfish._XML
    for n in (2, 4):
        assert stacker._props_xml(n) == jstacker._props_xml(n)


@pytest.mark.parametrize('domain,task', [
    ('stacker', 'stack_2'), ('fish', 'swim'),
    pytest.param('stacker', 'stack_4', marks=pytest.mark.skipif(
        not HEAVY, reason='~7 s of JAX compile on one core; RUN_HEAVY=1')),
    pytest.param('fish', 'upright', marks=pytest.mark.skipif(
        not HEAVY, reason='~5 s of JAX compile on one core; RUN_HEAVY=1'))])
def test_model_matches_jax_field_by_field(domain, task):
    jm = jenv_of(domain, task).model
    tm = suite.load(domain, task, device='cpu').model
    assert_model_matches(jm, tm, held_apart=INVWEIGHTS)
    assert_invweights_close(jm, tm, _xml(task))
    if domain == 'fish':
        assert tm.actuator_biastype == (M.BIAS_AFFINE,) * 5
        assert tm.actuator_trntype[2] == M.TRN_TENDON
        kp = tm.actuator_gainprm[:, 0].numpy()
        np.testing.assert_allclose(kp, [5e-4, 1e-4, 3e-4, 1e-4, 1e-4])
        np.testing.assert_array_equal(tm.actuator_biasprm[:, 1].numpy(), -kp)
        assert tm.opt.disableflags & M.DSBL_CONTACT
    else:
        n = int(task[-1])
        boxes = [g for g in range(tm.ngeom) if tm.geom_type[g] == M.BOX]
        assert len(boxes) == n + 1 and tm.nq == tm.nv == 11 + 3 * (n - 1)
        assert len(tm.eq_tendon) == 1


# ---- the box pair kernels ---------------------------------------------


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1).astype(np.float32)


def pair_poses(kind, seed):
    """N_PAIRS random (p1, R1, s1, p2, R2, s2) of a pair kind: sizes as
    the stacker's and the manipulator's (box half-size .022, sphere .022,
    capsule radius .008 half-length .02), the second geom placed at a
    random direction from the first at a distance drawn around touching,
    so about half are in contact."""
    rng = np.random.RandomState(seed)
    n = N_PAIRS
    size = {'plane': [.4, .2, 10.], 'sphere': [.022, 0, 0],
            'capsule': [.008, .02, 0], 'box': [.022, .022, .022]}
    reach = {'plane': 0.0, 'sphere': .022, 'capsule': .028, 'box': .03}
    g1, g2 = kind
    R1, R2 = _rotations(rng, n), _rotations(rng, n)
    if g1 == 'plane':
        R1 = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if g1 == 'plane':
        d = np.abs(d) * [0, 0, 1] + [0, 0, 1e-3]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    gap = (reach[g1] + reach[g2]) * rng.uniform(0.4, 1.2, n)
    p1 = rng.uniform(-.3, .3, (n, 3)).astype(np.float32)
    p2 = (p1 + d * gap[:, None]).astype(np.float32)
    s = lambda g: np.broadcast_to(np.float32(size[g]), (n, 3)).copy()
    return p1, R1, s(g1), p2, R2, s(g2)


KINDS = {('plane', 'box'): M.PLANE, ('sphere', 'box'): M.SPHERE,
         ('capsule', 'box'): M.CAPSULE, ('box', 'box'): M.BOX}


@pytest.mark.parametrize('kind', list(KINDS))
def test_box_pair_kernel_matches_jax(kind):
    key = (KINDS[kind], M.BOX)
    args = pair_poses(kind, seed=len(kind[0]))
    jk = jcollision._KERNELS[key]

    def jfn(*a):
        d, p, nrm = jk(*a)
        t1, t2 = jax.vmap(jcollision._tangent_frame)(nrm)
        return d, p, jnp.stack([nrm, t1, t2], 1)

    jd, jp, jf = (np.asarray(x) for x in jax.jit(jax.vmap(jfn))(*args))
    # the port's kernels take (B, P, ...) poses with (P, 3) sizes: one
    # pair a batch row here
    p1, R1, s1, p2, R2, s2 = (torch.as_tensor(a) for a in args)
    d, p, nrm = collision._KERNELS[key](p1[:, None], R1[:, None], s1[:1],
                                        p2[:, None], R2[:, None], s2[:1])
    k = collision._PAIR_POINTS[key]
    d, p, nrm = d.reshape(N_PAIRS, k), p.reshape(N_PAIRS, k, 3), nrm.reshape(
        N_PAIRS, k, 3)
    t1, t2 = collision._tangent_frame(nrm)
    frame = torch.stack([nrm, t1, t2], -2)
    assert jd.shape == (N_PAIRS, k)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-5)
    # a point whose distance ties another of its pair: its place in the
    # deepest-k order is rounding's
    tie = ((np.abs(jd[:, :, None] - jd[:, None, :]) < 1e-6).sum(2) > 1)
    np.testing.assert_allclose(p.numpy()[~tie], jp[~tie], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(frame.numpy()[~tie], jf[~tie], rtol=1e-5,
                               atol=1e-5)
    inside = (jd < 0).any(1)
    assert 0.2 < inside.mean() < 0.95, inside.mean()
    assert tie.mean() < 0.5


# ---- stack_2 in contact: detect and the 641-row solve -----------------


def stack_poses(tm, n, seed):
    """stack_2 draws of its reset that penetrate by under 1 cm, random
    velocities and controls."""
    task = stacker.Stack(2, True)
    qposes, _ = task.attempts(tm, 32, torch.Generator().manual_seed(seed))
    q = qposes.reshape(-1, tm.nq)
    kin = smooth.kinematics(tm, q, smooth.tree_meta(tm))
    con = collision.detect(tm, kin[3], kin[4], collision.candidate_pairs(tm))
    boxes = [c for c, (g1, g2) in enumerate(zip(con.geom1, con.geom2))
             if M.BOX in (tm.geom_type[g1], tm.geom_type[g2])]
    pen = (con.dist < 0)
    keep = (pen[:, boxes].any(1) & (con.dist > -0.01).all(1)).nonzero()[:, 0]
    assert len(keep) >= n
    rng = np.random.RandomState(seed)
    qvel = rng.normal(0.0, 0.3, (n, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1.0, 1.0, (n, tm.nu)).astype(np.float32)
    return q[keep[:n]].numpy(), qvel, ctrl


@pytest.fixture(scope='module')
def stack2():
    jm = jenv_of('stacker', 'stack_2').model
    tm = with_jax_invweights(suite.load('stacker', 'stack_2',
                                        device='cpu').model, jm)
    q, v, u = stack_poses(tm, B, seed=0)
    return jm, tm, q, v, u


def test_detect_on_stack_2_matches_jax(stack2):
    """211 contact points of 136 candidate pairs (plane-box, sphere-box,
    capsule-box and box-box among them) in candidate order."""
    jm, tm, q, _, _ = stack2
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(jm) and len(pairs) == 136

    def jdetect(qq):
        kin = jsmooth.kinematics(jm, qq, jsmooth.tree_meta(jm))
        c = jcollision.detect(jm, kin[3], kin[4], pairs)
        return c.dist, c.pos, c.frame

    jd, jp, jf = (np.asarray(x) for x in jax.jit(jax.vmap(jdetect))(q))
    kin = smooth.kinematics(tm, torch.as_tensor(q), smooth.tree_meta(tm))
    con = collision.detect(tm, kin[3], kin[4], pairs)
    assert con.dist.shape == (B, 211)
    np.testing.assert_allclose(con.dist.numpy(), jd, rtol=1e-5, atol=1e-5)
    # rows whose pair has another point at the same distance (to 1e-6)
    tie = np.zeros_like(jd, bool)
    r = 0
    for g1, g2 in pairs:
        k = collision._PAIR_POINTS[(tm.geom_type[g1], tm.geom_type[g2])]
        d = jd[:, r:r + k]
        tie[:, r:r + k] = (np.abs(d[:, :, None] - d[:, None, :])
                           < 1e-6).sum(2) > 1
        r += k
    np.testing.assert_allclose(con.pos.numpy()[~tie], jp[~tie], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(con.frame.numpy()[~tie], jf[~tie], rtol=1e-5,
                               atol=1e-5)
    assert (jd < 0).any(1).all()


def test_apgd_plain_641_rows_matches_jax(stack2):
    """#1's plain twin on the cold and warm 641-row solves of two substeps
    from the stack_2 poses against JAX's vmapped XLA iterate. JAX's rule
    drops a row whose scaled diagonal is under 1e-9 of the largest over
    all rows, active or not; the near-massless fingertips' contact rows
    reach ~1e11, so the boxes' rows (~1-700) drop and the equality row
    carries the force here, as in JAX."""
    _, tm, q, v, u = stack2
    ts = State(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
               time=torch.zeros(B))
    captured = capture_solves(tm, ts, torch.as_tensor(u))
    assert [kw['cold'] for _, kw in captured] == [True, False]
    assert apgd_solve.dense_route(641) == 'global'
    for args, kw in captured:
        assert args[0].shape == (B, 641, 641)
        assert (kw['eq_rows'], kw['nonneg'], kw['con0']) == (
            (0,), tuple(range(1, 8)), tuple(range(8, 641, 3)))
        f, v_ = apgd_solve.apgd_iterate_batched(
            *[torch.as_tensor(a) for a in args], **kw)
        ref = jax_iterate(args, kw)
        np.testing.assert_allclose(f.numpy(), ref[0], **APGD_TOL)
        np.testing.assert_allclose(v_.numpy(), ref[1], **APGD_TOL)
        assert np.abs(ref[0][:, 0]).max() > 1e-3
        assert (args[4][:, 8:].sum(1) > 0).all()


# ---- resets and steps --------------------------------------------------


def test_stacker_reset():
    """The port's own stack_4 reset: the first collision-free of 8 draws
    where one is, the target column a box size times 1, 3, 5 or 7 high,
    its body moved per env."""
    env = suite.load('stacker', 'stack_4', device='cpu')
    m = env.model
    state, ts = env.reset(64, torch.Generator().manual_seed(0))
    z = state.params[:, 1].numpy() / stacker._BOX_SIZE
    np.testing.assert_allclose(z, np.round(z), atol=1e-5)
    assert set(np.round(z).astype(int)) <= {1, 3, 5, 7}
    assert len(set(np.round(z).astype(int))) > 1
    assert (np.abs(state.params[:, 0].numpy()) <= .37).all()
    np.testing.assert_allclose(ts.observation['target_pos'].numpy(),
                               state.params.numpy(), atol=1e-6)
    kin = smooth.kinematics(m, state.physics.qpos, smooth.tree_meta(m))
    pen = (collision.detect(m, kin[3], kin[4], collision.candidate_pairs(
        m)).dist < 0).any(1)
    assert pen.float().mean() < 0.5
    assert ts.observation['box_pos'].shape == (64, 4, 4)


@pytest.mark.skipif(not HEAVY, reason='the JAX stacker reset and step '
                    'compile take ~2 min on one core; RUN_HEAVY=1')
def test_stack_2_reset_and_step_from_jax():
    """The rejection rule on JAX's own eight attempts an env, and one
    control step from the JAX-drawn resets with numpy actions (atol =
    rtol = 1e-4)."""
    jenv = jenv_of('stacker', 'stack_2')
    env = suite.load('stacker', 'stack_2', device='cpu')
    acts = np.random.RandomState(3).uniform(
        -1, 1, (B, 5)).astype(np.float32)

    def one(key, a):
        phys, params, att = recording_init(jenv._task, jenv.model, key)
        s0, _ = jax_env_state(jenv, phys, params)
        s1, ts1 = jenv.step(s0, a)
        return s0, att, s1, ts1

    keys = jax.random.split(jax.random.PRNGKey(7), B)
    s0, (qposes, params, penet), s1, ts1 = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(one))(keys, acts))
    att = torch.as_tensor(np.transpose(qposes, (1, 0, 2)).copy())
    idx = randomizers.first_collision_free_index(env.model, att).numpy()
    np.testing.assert_array_equal(qposes[np.arange(B), idx],
                                  s0.physics.qpos)
    np.testing.assert_array_equal(params[np.arange(B), idx], s0.params)
    state = _port_state(s0)
    t1, ts = env.step(state, torch.as_tensor(acts))
    for ours, ref, name in ((t1.physics.qpos, s1.physics.qpos, 'qpos'),
                            (t1.physics.qvel, s1.physics.qvel, 'qvel'),
                            (ts.reward, ts1.reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name,
                                   **STEP_TOL)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), ts1.observation[k],
                                   err_msg=k, **STEP_TOL)


def test_fish_affine_bias_matches_jax():
    """actuation's force and qfrc: gain kp ctrl plus bias -kp length on
    the joints' qpos and on the fins' fixed tendon, clamped ctrl."""
    from mujoco_mbrl_tpu.physics import smooth as js
    jm = jenv_of('fish', 'swim').model
    tm = suite.load('fish', 'swim', device='cpu').model
    rng = np.random.RandomState(4)
    q = rng.normal(0, .3, (B, tm.nq)).astype(np.float32)
    v = rng.normal(0, 1, (B, tm.nv)).astype(np.float32)
    u = rng.uniform(-1.5, 1.5, (B, tm.nu)).astype(np.float32)
    jf, jq, _ = (np.asarray(x) if x is not None else None
                 for x in jax.jit(jax.vmap(
                     lambda a, b, c: js.actuation(jm, a, b, c)))(q, v, u))
    f, qf, _ = smooth.actuation(tm, torch.as_tensor(q), torch.as_tensor(v),
                                torch.as_tensor(u))
    np.testing.assert_allclose(f.numpy(), jf, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(qf.numpy(), jq, rtol=1e-5, atol=1e-9)
    # the bias is on: a zero ctrl still pushes the joints toward 0
    f0, _, _ = smooth.actuation(tm, torch.as_tensor(q), torch.as_tensor(v),
                                torch.zeros(B, tm.nu))
    assert float(f0.abs().min()) > 0


def fish_episode(task):
    """JAX-drawn resets of a fish task and one control step of numpy
    actions from them, one jitted call."""
    acts = np.random.RandomState(6).uniform(-1, 1, (B, 5)).astype(
        np.float32)
    jenv = jenv_of('fish', task)

    def one(key, a):
        phys, params = jenv._task.initialize_episode(jenv.model, key)
        s0 = jax_env_state(jenv, phys, params, observe=False)
        s1, ts1 = jenv.step(s0, a)
        return s0, s1, ts1

    keys = jax.random.split(jax.random.PRNGKey(8), B)
    return acts, jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(
        keys, acts))


@pytest.mark.parametrize('task', [
    'swim', pytest.param('upright', marks=pytest.mark.skipif(
        not HEAVY, reason='the JAX fish step compiles in ~20 s on one core '
        '(swim, by default, shares all but its observation and reward); '
        'RUN_HEAVY=1'))])
def test_fish_control_step_from_jax_reset_matches(task):
    acts, (s0, s1, ts1) = fish_episode(task)
    env = suite.load('fish', task, device='cpu')
    assert env._n_sub_steps == 10
    state = _port_state(s0)
    if task == 'swim':
        assert state.params.shape == (B, 3)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(state.physics.qpos[:, 3:7], dim=1).numpy(),
        1.0, atol=1e-6)
    seen = []
    real = apgd_solve.apgd_iterate_batched
    apgd_solve.apgd_iterate_batched = lambda *a, **k: seen.append(a)
    try:
        t1, ts = env.step(state, torch.as_tensor(acts))
    finally:
        apgd_solve.apgd_iterate_batched = real
    assert not seen                       # no constraint row, no solve
    for ours, ref, name in ((t1.physics.qpos, s1.physics.qpos, 'qpos'),
                            (t1.physics.qvel, s1.physics.qvel, 'qvel'),
                            (ts.reward, ts1.reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name,
                                   **STEP_TOL)
    assert list(ts.observation) == sorted(ts1.observation)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), ts1.observation[k],
                                   err_msg=k, **STEP_TOL)


def test_fish_reset_draws():
    env = suite.load('fish', 'swim', device='cpu')
    state, _ = env.reset(256, torch.Generator().manual_seed(1))
    q = state.physics.qpos
    np.testing.assert_allclose(torch.linalg.vector_norm(q[:, 3:7], dim=1),
                               1.0, atol=1e-6)
    assert float(q[:, 7:].abs().max()) <= .2
    lo, hi = np.array([-.4, -.4, .1]), np.array([.4, .4, .3])
    p = state.params.numpy()
    assert ((p >= lo) & (p <= hi)).all()


@pytest.mark.parametrize('domain,task', [('stacker', t) for t in STACKS]
                         + [('fish', 'upright'), ('fish', 'swim')])
def test_tracks_mujoco_fixture(domain, task):
    bands = {**THRESHOLDS, **HEAVY_THRESHOLDS}
    tracks_mujoco_fixture(domain, task,
                          suite.load(domain, task, device='cpu').model,
                          *bands[(domain, task)])


def test_registered_as_in_jax():
    from mujoco_mbrl_tpu import suite as jsuite
    ported = set(suite._DOMAINS)
    assert {'manipulator', 'stacker', 'fish'} <= ported
    assert suite.all_tasks() == tuple(
        t for t in jsuite.all_tasks() if t[0] in ported)
    assert suite.benchmarking() == tuple(
        t for t in jsuite.benchmarking() if t[0] in ported)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    for domain, task in [('stacker', t) for t in STACKS] + [
            ('fish', 'upright'), ('fish', 'swim')]:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load(domain, task)
