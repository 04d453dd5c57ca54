"""quadruped (filtered actuators, ellipsoid and heightfield contacts,
condim-6 pyramids, the IMU and force-torque sensors; 240, 356 and 914
dense rows), port against the JAX package.

Same inputs, drawn with numpy from a seed or by the JAX reset, go through
both packages (B = 4):

* ``_make_xml`` (walk / run, escape's terrain, fetch's walls and ball) is
  the JAX module's, and the compiled models match field by field (rtol
  1e-5): the general actuators' gain, bias and filter dynamics, the
  activation slots, the heightfield, the walls' orientation, the ball's
  priority, condim and direct solref; mj_setConst's weights of walk at
  rtol 1e-5 (escape's and fetch's behind RUN_HEAVY=1: JAX compiles them
  in ~10 s a model on one core, so the other default tests give the JAX
  model the port's weights and compare the rows, not those weights);
* ``actuation`` with activations against JAX's at random states, controls
  and activations, filters and integrators (rtol 1e-5);
* the pair kernels (plane-ellipsoid, hfield-sphere, -capsule, -ellipsoid)
  and ``hfield_height_normal`` against JAX's on random poses in contact
  and apart, each pair on its own terrain (rtol = atol = 1e-5);
* escape's terrain: the bowl times the bumps resized as
  ``jax.image.resize(..., 'cubic')`` on JAX's own bumps (atol 1e-5), and
  the port's draws by their law;
* the rows: condim 3, 4 and 6 pyramids on a small scene by default, and
  fetch's 914 rows at poses in contact behind RUN_HEAVY=1 (its JAX
  compile takes ~16 s): J, aref, R, active, mu, the block list and the
  pyramids (rtol 1e-5), and ``contact_forces`` from random row forces;
* the eight sensor functions and each task's observation and reward on
  the port's own forward Data, handed to JAX (rtol 1e-4; the
  rangefinder on each env's terrain);
* #1's plain twin on the cold and warm 240-row walk solves the port's own
  substeps build, against JAX's vmapped XLA iterate (rtol = atol = 2e-4);
* control steps from JAX-drawn resets (walk, escape with JAX's terrain,
  fetch: qpos, qvel, act, reward and every observation key at atol =
  rtol = 1e-4), behind RUN_HEAVY=1: JAX compiles a quadruped reset and
  step in ~60 s and ~75 s on one core;
* the MuJoCo parity fixtures within tests/test_parity_physics.py
  HEAVY_THRESHOLDS (walk and run 14 steps, escape 12 at 1e-3, fetch 4 at
  1e-2; port-only runs from the fixture's activations and terrain);
* the port's resets, autoreset with activations, the task lists and the
  card as the default device.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import quadruped as jquadruped
from mujoco_mbrl_tpu.suite import sensors as jsensors
from mujoco_mbrl_tpu_torch import convert, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, engine, mjcf, smooth
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics import solver
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import quadruped, sensors
from test_parity_physics import HEAVY_THRESHOLDS
from test_torch_cartpole import (APGD_TOL, B, STEP_TOL, assert_model_matches,
                                 jenv_of, tracks_mujoco_fixture)
from test_torch_contact_free import _jax_reset, _port_state
from test_torch_finger import capture_solves
from test_torch_manipulator import INVWEIGHTS, jax_iterate

HEAVY = os.environ.get('RUN_HEAVY', '') == '1'
TASKS = ('walk', 'run', 'escape', 'fetch')
XML_ARGS = {'walk': dict(floor_size=10), 'run': dict(floor_size=100),
            'escape': dict(floor_size=40, terrain=True),
            'fetch': dict(floor_size=15, walls_and_ball=True)}
TOL5 = dict(rtol=1e-5, atol=1e-5)
SENSOR_TOL = dict(rtol=1e-4, atol=1e-4)
N_PAIRS = 48


def heavy(reason):
    return pytest.mark.skipif(not HEAVY, reason=f'{reason}; RUN_HEAVY=1')


_JMODELS = {}


def jax_model(task):
    """The JAX model of a task, compiled by the JAX ``mjcf.parse`` but for
    mj_setConst's weights, which it takes from the port's model (JAX
    jit-compiles those in ~10 s a model; ``test_invweights_match_jax``
    holds them)."""
    if task not in _JMODELS:
        real = jmjcf._with_invweight0
        jmjcf._with_invweight0 = lambda m: m
        try:
            jm = jmjcf.parse(jquadruped._make_xml(**XML_ARGS[task]))
        finally:
            jmjcf._with_invweight0 = real
        tm = port_model(task)
        _JMODELS[task] = jm.replace(**{
            n: jnp.asarray(getattr(tm, n).numpy()) for n in INVWEIGHTS})
    return _JMODELS[task]


def port_model(task):
    return suite.load('quadruped', task, device='cpu').model


def test_xml_is_a_copy():
    for args in XML_ARGS.values():
        assert quadruped._make_xml(**args) == jquadruped._make_xml(**args)


@pytest.mark.parametrize('task', ['walk', 'escape', 'fetch'])
def test_model_matches_jax_field_by_field(task):
    tm = port_model(task)
    assert_model_matches(jax_model(task), tm, held_apart=INVWEIGHTS)
    assert tm.na == tm.nu == 12
    assert tm.actuator_dyntype == (M.DYN_FILTER,) * 12
    assert tm.actuator_actadr == tuple(range(12))
    assert tm.actuator_biastype == (M.BIAS_AFFINE,) * 12
    np.testing.assert_allclose(tm.actuator_dynprm[:, 0].numpy(), 0.1)
    np.testing.assert_allclose(tm.actuator_gainprm[:, 0].numpy(), 1000.)
    np.testing.assert_allclose(tm.actuator_biasprm[:, 1].numpy(), -1000.)
    assert len(tm.eq_tendon) == 4
    torso = tm.name2id('geom', 'torso')
    assert tm.geom_type[torso] == M.ELLIPSOID
    if task == 'escape':
        assert (tm.hfield_nrow, tm.hfield_ncol) == (201, 201)
        np.testing.assert_allclose(tm.hfield_size.numpy(), [30, 30, 5, .1])
        np.testing.assert_allclose(tm.hfield_pos.numpy(), [0, 0, -.01])
        assert tm.hfield_data.shape == (201, 201)
    else:
        assert tm.hfield_nrow == 0 and tm.hfield_data is None
    if task == 'fetch':
        ball = tm.name2id('geom', 'ball')
        assert (tm.geom_priority[ball], tm.geom_condim[ball]) == (1, 6)
        np.testing.assert_allclose(tm.geom_solref[ball].numpy(),
                                   [-10000, -30])
        wall = tm.name2id('geom', 'wall_px')
        # zaxis (1, 0, 1): a 45 degree turn about y
        np.testing.assert_allclose(
            tm.geom_quat[wall].numpy(),
            [np.cos(np.pi / 8), 0, np.sin(np.pi / 8), 0], atol=1e-6)


@pytest.mark.parametrize('task', [
    'walk', pytest.param('escape', marks=heavy('~10 s of JAX compile')),
    pytest.param('fetch', marks=heavy('~10 s of JAX compile'))])
def test_invweights_match_jax(task):
    """mj_setConst's weights at qpos0: the packages within rtol 1e-5 of
    each other on walk and escape; on fetch, whose 14 kg ball the float32
    mass matrix carries beside the legs' links, each package's float32
    M^-1 parts from the float64 compile by up to ~5e-5, so there both are
    held within rtol 1e-4 of the port's float64 compile."""
    jm, tm = jenv_of('quadruped', task).model, port_model(task)
    m64 = mjcf.parse(quadruped._make_xml(**XML_ARGS[task]),
                     dtype=torch.float64)
    for name in INVWEIGHTS:
        ours, ref = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        if task == 'fetch':
            for x in (ours, ref):
                np.testing.assert_allclose(x, getattr(m64, name).numpy(),
                                           rtol=1e-4, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


# ---- actuation with activations ---------------------------------------


@pytest.mark.parametrize('dyn', ['filter', 'mixed'])
def test_actuation_with_activations_matches_jax(dyn):
    """Force, qfrc and act_dot at random states, controls beyond the
    ranges and activations; 'mixed' makes every other actuator an
    integrator (on both sides)."""
    jm, tm = jax_model('walk'), port_model('walk')
    if dyn == 'mixed':
        types = tuple(M.DYN_INTEGRATOR if u % 2 else M.DYN_FILTER
                      for u in range(12))
        jm, tm = (jm.replace(actuator_dyntype=types),
                  tm.replace(actuator_dyntype=types))
    rng = np.random.RandomState(4)
    q = np.tile(np.asarray(jm.qpos0), (B, 1)).astype(np.float32)
    q[:, 7:] += rng.normal(0, .4, (B, 16)).astype(np.float32)
    v = rng.normal(0, 1, (B, tm.nv)).astype(np.float32)
    u = rng.uniform(-1.5, 1.5, (B, tm.nu)).astype(np.float32)
    a = rng.uniform(-1, 1, (B, tm.na)).astype(np.float32)
    jf, jq, jad = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda *x: jsmooth.actuation(jm, *x)))(q, v, u, a))
    f, qf, ad = smooth.actuation(tm, *(torch.as_tensor(x)
                                       for x in (q, v, u, a)))
    np.testing.assert_allclose(f.numpy(), jf, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(qf.numpy(), jq, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ad.numpy(), jad, rtol=1e-5, atol=1e-6)
    # the gain reads the activation, not the ctrl
    f_u, _, _ = smooth.actuation(tm, *(torch.as_tensor(x)
                                       for x in (q, v, 2 * u, a)))
    np.testing.assert_allclose(f_u.numpy(), f.numpy(), rtol=1e-6)
    lo, hi = tm.actuator_ctrlrange[:, 0].numpy(), \
        tm.actuator_ctrlrange[:, 1].numpy()
    filt = np.array([t == M.DYN_FILTER for t in tm.actuator_dyntype])
    want = np.where(filt, (np.clip(u, lo, hi) - a) / 0.1, np.clip(u, lo, hi))
    np.testing.assert_allclose(ad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_activations_advance_in_steps_and_state_conversion():
    """Euler advances act by h act_dot; with no act the gain reads the
    ctrl (RK4's stage passes); ``convert.env_state`` carries act."""
    tm = port_model('walk')
    s = M.make_state(tm, batch=2)
    assert s.act.shape == (2, 12) and float(s.act.abs().max()) == 0
    u = torch.full((2, 12), 0.5)
    s1 = engine.step(tm, s, u)
    np.testing.assert_allclose(s1.act.numpy(), 0.005 * 0.5 / 0.1, rtol=1e-6)
    d = engine.forward(tm, s1, u)
    np.testing.assert_allclose(
        d.act_dot.numpy(), (0.5 - s1.act.numpy()) / 0.1, rtol=1e-5)
    assert engine.forward(tm, s1, u, acc_stage=False).act_dot.shape == (2, 12)
    assert smooth.actuation(tm, s.qpos, s.qvel, u)[2] is None
    es = convert.env_state(s1.qpos.numpy(), s1.qvel.numpy(),
                           act=s1.act.numpy())
    np.testing.assert_array_equal(es.physics.act.numpy(), s1.act.numpy())


# ---- pair kernels and the heightfield ---------------------------------


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


def terrains(n, seed):
    """n escape terrains of the JAX law from numpy bumps (float32)."""
    rng = np.random.RandomState(seed)
    bumps = rng.uniform(.15, 1., (n, 30, 30)).astype(np.float32)
    return (quadruped.terrain_bowl() * quadruped.resize_cubic(
        torch.as_tensor(bumps), 201)).numpy()


SIZES = {'sphere': [.08, 0, 0], 'capsule': [.065, .18, 0],
         'ellipsoid': [.3, .27, .2]}
KINDS = {('plane', 'ellipsoid'): (M.PLANE, M.ELLIPSOID),
         ('hfield', 'sphere'): (M.HFIELD, M.SPHERE),
         ('hfield', 'capsule'): (M.HFIELD, M.CAPSULE),
         ('hfield', 'ellipsoid'): (M.HFIELD, M.ELLIPSOID)}


def hfield_models(n, seed):
    """The escape models of both packages with n per-env terrains (the
    port's as a per-env field, JAX's to be mapped), and those terrains."""
    tm, jm = port_model('escape'), jax_model('escape')
    t = terrains(n, seed)
    return M.with_env_fields(tm, hfield_data=torch.as_tensor(t)), jm, t


def pair_poses(kind, tm, seed):
    """N_PAIRS random poses of a pair kind, the second geom at a random
    direction from the plane (tilted) or above the terrain under it, at a
    gap drawn around touching, so about half are in contact; a few of
    the terrain's lie past its edge (the grid clamps)."""
    rng = np.random.RandomState(seed)
    n = N_PAIRS
    g1, g2 = kind
    R1 = (_rotations(rng, n) if g1 == 'plane' else
          np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy())
    R2 = _rotations(rng, n)
    reach = max(SIZES[g2][:2]) if g2 != 'ellipsoid' else .25
    gap = reach * rng.uniform(0.4, 1.6, n)
    if g1 == 'plane':
        p1 = rng.uniform(-1, 1, (n, 3))
        p2 = p1 + R1[:, :, 2] * gap[:, None] + np.einsum(
            'nij,nj->ni', R1, rng.normal(0, .5, (n, 3)) * [1, 1, 0])
    else:
        p1 = np.broadcast_to(tm.hfield_pos.numpy(), (n, 3)).copy()
        xy = rng.uniform(-29.5, 29.5, (n, 2))
        xy[:4] = rng.uniform(30.5, 33, (4, 2)) * rng.choice([-1, 1], (4, 2))
        h = collision.hfield_height(tm, torch.as_tensor(xy[:, :1],
                                                        dtype=torch.float32),
                                    torch.as_tensor(xy[:, 1:],
                                                    dtype=torch.float32))
        p2 = np.concatenate([xy, h.numpy() + gap[:, None]], 1)
    s = lambda g: np.broadcast_to(np.float32(SIZES.get(g, [40, 40, .5])),
                                  (n, 3)).copy()
    return (p1.astype(np.float32), R1, s(g1), p2.astype(np.float32), R2,
            s(g2))


@pytest.mark.parametrize('kind', list(KINDS))
def test_pair_kernel_matches_jax(kind):
    key = KINDS[kind]
    tm, jm, t = hfield_models(N_PAIRS, seed=3)
    args = pair_poses(kind, tm, seed=len(kind[1]))

    def jfn(terrain, *a):
        fn = (jcollision._HFIELD_KERNELS[key](jm.replace(
            hfield_data=terrain)) if key in jcollision._HFIELD_KERNELS
            else jcollision._KERNELS[key])
        d, p, nrm = fn(*a)
        t1, t2 = jax.vmap(jcollision._tangent_frame)(nrm)
        return d, p, jnp.stack([nrm, t1, t2], 1)

    jd, jp, jf = (np.asarray(x) for x in jax.jit(jax.vmap(jfn))(t, *args))
    p1, R1, s1, p2, R2, s2 = (torch.as_tensor(a) for a in args)
    fn = (collision._HFIELD_KERNELS[key](tm)
          if key in collision._HFIELD_KERNELS else collision._KERNELS[key])
    d, p, nrm = fn(p1[:, None], R1[:, None], s1[:1], p2[:, None],
                   R2[:, None], s2[:1])
    k = collision._PAIR_POINTS[key]
    d, p, nrm = (d.reshape(N_PAIRS, k), p.reshape(N_PAIRS, k, 3),
                 nrm.reshape(N_PAIRS, k, 3))
    t1, t2 = collision._tangent_frame(nrm)
    np.testing.assert_allclose(d.numpy(), jd, **TOL5)
    np.testing.assert_allclose(p.numpy(), jp, **TOL5)
    np.testing.assert_allclose(torch.stack([nrm, t1, t2], -2).numpy(), jf,
                               **TOL5)
    inside = (jd < 0).any(1)
    assert 0.2 < inside.mean() < 0.9, inside.mean()


def test_hfield_height_normal_matches_jax():
    tm, jm, t = hfield_models(8, seed=5)
    rng = np.random.RandomState(6)
    xy = rng.uniform(-32, 32, (8, 64, 2)).astype(np.float32)
    jh, jn = (np.asarray(x) for x in jax.jit(jax.vmap(jax.vmap(
        lambda p, terrain: jcollision.hfield_height_normal(
            jm.replace(hfield_data=terrain), p[0], p[1]),
        in_axes=(0, None))))(xy, t))
    h, n = collision.hfield_height_normal(tm, torch.as_tensor(xy[..., 0]),
                                          torch.as_tensor(xy[..., 1]))
    np.testing.assert_allclose(h.numpy(), jh, **TOL5)
    np.testing.assert_allclose(n.numpy(), jn, **TOL5)
    # one shared grid reads the same as the same grid per env
    shared = tm.replace(hfield_data=torch.as_tensor(t[0]))
    h0, _ = collision.hfield_height_normal(
        shared, torch.as_tensor(xy[0, :, 0]), torch.as_tensor(xy[0, :, 1]))
    np.testing.assert_allclose(h0.numpy(), jh[0], **TOL5)


def test_terrain_matches_jax():
    """JAX's _generate_terrain against the port's bowl times the resize of
    the same bumps (JAX draws them from the key's uniform), and the
    resize's weights against jax.image's own."""
    from jax._src.image import scale as jscale
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    for key in keys:
        want = np.asarray(jquadruped._generate_terrain(key))
        bumps = np.array(jax.random.uniform(key, (30, 30), minval=.15,
                                            maxval=1.0))
        got = quadruped.terrain_bowl() * quadruped.resize_cubic(
            torch.as_tensor(bumps)[None], 201)
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)
    w = np.asarray(jscale.compute_weight_mat(
        30, 201, jnp.float32(201 / 30), jnp.float32(0.),
        jscale._fill_keys_cubic_kernel, True))
    # JAX forms them in float32, the port in float64
    np.testing.assert_allclose(quadruped.keys_cubic_weights(30, 201), w,
                               atol=1e-5)


def test_port_terrain_draws_follow_the_law():
    """The port's own terrain draws: the bowl times the resized uniform
    bumps in mean (0.575 bowl) and in variance (0.85^2 / 12 bowl^2 times
    the squared weights' sums), over 256 envs."""
    m = port_model('escape')
    t = quadruped.generate_terrain(m, 256, torch.Generator().manual_seed(0))
    assert t.shape == (256, 201, 201)
    bowl = quadruped.terrain_bowl().double()
    W = torch.as_tensor(quadruped.keys_cubic_weights(30, 201))
    s2 = (W ** 2).sum(0)
    var = 0.85 ** 2 / 12 * bowl ** 2 * s2[:, None] * s2[None, :]
    t = t.double()
    assert abs(float(t.mean(0).mean() / (0.575 * bowl.mean())) - 1) < 5e-3
    assert abs(float(t.var(0).mean() / var.mean()) - 1) < 0.03
    # the cubic over- and undershoots the bumps' range, never below 0
    assert float(t.min()) >= 0


# ---- rows --------------------------------------------------------------

_SCENE = """
<mujoco>
  <option timestep='.005'/>
  <worldbody>
    <geom name='floor' type='plane' size='5 5 .5' solref='.01 1'/>
    <body name='ball' pos='0 0 .14'>
      <freejoint/>
      <geom name='ball' type='sphere' size='.15' priority='1' condim='6'
            friction='.7 .005 .005' solref='-10000 -30'/>
    </body>
    <body name='rod' pos='.3 0 .06'>
      <freejoint/>
      <geom name='rod' type='capsule' size='.07 .2' condim='4'
            friction='.9 .02 .001' euler='0 90 10'/>
    </body>
    <body name='pebble' pos='-.2 .05 .07'>
      <freejoint/>
      <geom name='pebble' type='sphere' size='.08' condim='1'/>
    </body>
  </worldbody>
</mujoco>
"""


def _jax_rows(jm, q, v):
    """JAX's assembly at poses q (B, nq): (J, aref, R, active, mu) as
    numpy, and its static block list and pyramids."""
    seen = []

    def asm(qq, vv):
        meta = jsmooth.tree_meta(jm)
        kin = jsmooth.kinematics(jm, qq, meta)
        cdof = jsmooth.motion_subspace(jm, kin[1], kin[6], kin[7], meta)
        con = jcollision.detect(jm, kin[3], kin[4],
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, meta, qq, vv, cdof, con,
                              site_xpos=kin[5])
        seen.append((cs.blocks, cs.pyramids))
        return cs.J, cs.aref, cs.R, cs.active, cs.mu

    out = [np.asarray(x) for x in jax.jit(jax.vmap(asm))(q, v)]
    return out, seen[0]


def _port_rows(tm, q, v):
    kin = smooth.kinematics(tm, q, smooth.tree_meta(tm))
    cdof = smooth.motion_subspace(tm, kin[1], kin[6], kin[7],
                                  smooth.tree_meta(tm))
    con = collision.detect(tm, kin[3], kin[4], collision.candidate_pairs(tm))
    return solver.assemble(tm, smooth.tree_meta(tm), q, v, cdof, con,
                           site_xpos=kin[5]), con


def assert_rows_match(cs, jrows, jstatic):
    J, aref, R, active, mu = jrows
    assert cs.blocks == jstatic[0] and cs.pyramids == jstatic[1]
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               (J, aref, R, active),
                               ('J', 'aref', 'R', 'active')):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    np.testing.assert_allclose(cs.mu.numpy(), mu[0], rtol=1e-6)


def test_condim_4_and_6_rows_match_jax():
    """A ball (condim 6 by priority), a rod (condim 4) and a frictionless
    pebble (which takes its partner's condim) on a floor and against each
    other: facet rows of 3, 4 and 6,
    grouped by condim in JAX's order, the rotational Jacobian's torsion
    and rolling directions, and contact_forces from random row forces."""
    tm = mjcf.parse(_SCENE)
    real = jmjcf._with_invweight0
    jmjcf._with_invweight0 = lambda m: m
    try:
        jm = jmjcf.parse(_SCENE)
    finally:
        jmjcf._with_invweight0 = real
    jm = jm.replace(**{n: jnp.asarray(getattr(tm, n).numpy())
                       for n in INVWEIGHTS})
    rng = np.random.RandomState(0)
    q = np.tile(tm.qpos0.numpy(), (B, 1))
    q[:, [0, 1, 7, 8, 14, 15]] += rng.normal(0, .02, (B, 6))
    q[:, [2, 9, 16]] -= rng.uniform(0, .02, (B, 3))
    q = q.astype(np.float32)
    v = rng.normal(0, .5, (B, tm.nv)).astype(np.float32)
    jrows, jstatic = _jax_rows(jm, q, v)
    cs, con = _port_rows(tm, torch.as_tensor(q), torch.as_tensor(v))
    assert_rows_match(cs, jrows, jstatic)
    assert sorted({p[2] for p in cs.pyramids}) == [2, 3, 5]
    assert (cs.active.numpy().sum(1) > 20).all()
    f = np.abs(rng.normal(0, 1, cs.aref.shape)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda x: jsolver.contact_forces(
        jsolver.ConstraintSet(*[None] * 4, jstatic[0], jnp.asarray(
            jrows[4][0]), (), jstatic[1]), x, len(con.geom1),
        jnp.float32))(f))
    got = solver.contact_forces(cs, torch.as_tensor(f), len(con.geom1), B,
                                torch.float32, 'cpu')
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def contact_state(task, n, seed):
    """n poses of the port's reset draws with the root lowered 3 cm into
    the floor (the toes and the legs in contact), fetch's ball against the
    front-left toe and the floor; random velocities, activations and
    controls."""
    tm = port_model(task)
    env = suite.load('quadruped', task, device='cpu')
    s, params = env.task.initialize_episode(
        tm, n, torch.Generator().manual_seed(seed))
    q = s.qpos.clone()
    q[:, 2] -= .03
    if task == 'fetch':
        kin = smooth.kinematics(tm, q, smooth.tree_meta(tm))
        toe = kin[5][:, tm.name2id('site', 'toe_front_left')]
        qa = tm.jnt_qposadr[tm.name2id('joint', 'ball_root')]
        q[:, qa:qa + 2] = toe[:, :2] + torch.tensor([.16, 0.])
        q[:, qa + 2] = .14
    rng = np.random.RandomState(seed)
    v = torch.as_tensor(rng.normal(0, .3, (n, tm.nv)), dtype=torch.float32)
    act = torch.as_tensor(rng.uniform(-1, 1, (n, tm.na)),
                          dtype=torch.float32)
    u = torch.as_tensor(rng.uniform(-1, 1, (n, tm.nu)), dtype=torch.float32)
    return State(qpos=q, qvel=v, time=torch.zeros(n), act=act), params, u


@heavy('the JAX assembly of fetch\'s 914 rows compiles in ~16 s on one '
       'core')
def test_fetch_914_rows_match_jax():
    s, _, _ = contact_state('fetch', B, 1)
    jrows, jstatic = _jax_rows(jax_model('fetch'), s.qpos.numpy(),
                               s.qvel.numpy())
    cs, con = _port_rows(port_model('fetch'), s.qpos, s.qvel)
    assert cs.J.shape == (B, 914, 28) and len(con.geom1) == 270
    assert_rows_match(cs, jrows, jstatic)
    assert [k for k, _ in cs.blocks[:20]] == ['equality'] * 4 + [
        'limit'] * 16
    assert sum(p[2] == 5 for p in cs.pyramids) == 21
    ball_rows = [i0 + r for _, i0, nd in cs.pyramids if nd == 5
                 for r in range(10)]
    assert (cs.active.numpy()[:, ball_rows].sum(1) > 0).all()


# ---- sensors, observations and rewards on the port's Data ---------------


def jax_data(td):
    """The port's batched Data as a JAX Data (numpy leaves)."""
    return JM.Data(**{f.name: (None if getattr(td, f.name) is None else
                               jnp.asarray(getattr(td, f.name).numpy()))
                      for f in dataclasses.fields(td)})


def jax_state(s):
    return JM.State(qpos=jnp.asarray(s.qpos.numpy()),
                    qvel=jnp.asarray(s.qvel.numpy()),
                    time=jnp.asarray(s.time.numpy()),
                    act=jnp.asarray(s.act.numpy()))


@pytest.fixture(scope='module')
def walk_forward():
    tm = port_model('walk')
    s, _, u = contact_state('walk', B, 2)
    return tm, s, u, engine.forward(tm, s, u)


def test_sensors_match_jax(walk_forward):
    """Each of the eight sensor functions on the same forward Data; the
    toes' force readings nonzero where they touch the floor."""
    tm, s, _, td = walk_forward
    jm, jd = jax_model('walk'), jax_data(td)
    qv = jnp.asarray(s.qvel.numpy())
    torso = tm.name2id('site', 'torso')
    toe = tm.name2id('site', 'toe_back_right')
    cases = {
        'site_xmat': (lambda d, v: jsensors.site_xmat(jm, d, toe),
                      sensors.site_xmat(tm, td, toe)),
        'gyro': (lambda d, v: jsensors.gyro(jm, d, torso),
                 sensors.gyro(tm, td, torso)),
        'velocimeter': (lambda d, v: jsensors.velocimeter(jm, d, torso),
                        sensors.velocimeter(tm, td, torso)),
        'body_cacc': (lambda d, v: jsensors.body_cacc(jm, d, v),
                      sensors.body_cacc(tm, td, s.qvel)),
        'accelerometer': (lambda d, v: jsensors.accelerometer(jm, d, v,
                                                              torso),
                          sensors.accelerometer(tm, td, s.qvel, torso)),
        'contact_force_on_body': (
            lambda d, v: jsensors.contact_force_on_body(
                jm, d, tm.site_body[toe]),
            sensors.contact_force_on_body(tm, td, tm.site_body[toe])),
        'force_site': (lambda d, v: jsensors.force_site(jm, d, toe),
                       sensors.force_site(tm, td, toe)),
        'torque_site': (lambda d, v: jsensors.torque_site(jm, d, toe),
                        sensors.torque_site(tm, td, toe)),
    }
    for name, (jfn, ours) in cases.items():
        ref = np.asarray(jax.vmap(jfn)(jd, qv))
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    toes = [tm.name2id('site', f'toe_{leg}') for leg in quadruped._LEGS]
    assert max(float(sensors.force_site(tm, td, t).abs().max())
               for t in toes) > 1.0


@pytest.mark.parametrize('task,rays', [
    ('walk', None), ('fetch', None), ('escape', (0, 7, 19)),
    pytest.param('escape', None, marks=heavy(
        'JAX\'s 20 rays take ~12 s on one core (op by op or compiled)'))])
def test_observation_and_reward_match_jax(task, rays, monkeypatch):
    """Each task's observation (every key; escape's rangefinder on each
    env's terrain: three of its rays by default, all 20 behind
    RUN_HEAVY=1) and reward on the port's forward Data, in contact."""
    if rays is not None:
        for mod in (quadruped, jquadruped):
            monkeypatch.setattr(mod, '_RF_ENDPOINTS', [
                mod._RF_ENDPOINTS[r] for r in rays])
    tm, jm = port_model(task), jax_model(task)
    s, params, u = contact_state(task, B, 3)
    env = suite.load('quadruped', task, device='cpu')
    m = env._model_with(params)
    td = engine.forward(m, s, u)
    obs = env.task.get_observation(m, s, td)
    rew = env.task.get_reward(m, s, td, u)
    jtask = jenv_task(task)

    def jfn(terrain, phys, d, ctrl):
        mm = jm if terrain is None else jm.replace(hfield_data=terrain)
        return (jtask.get_observation(mm, phys, d),
                jtask.get_reward(mm, phys, d, ctrl))

    terrain = None if task != 'escape' else jnp.asarray(params.numpy())
    jobs, jrew = jax.vmap(jfn)(terrain, jax_state(s), jax_data(td),
                               jnp.asarray(u.numpy()))
    assert sorted(obs) == list(jobs)       # a vmapped dict comes sorted
    for k, v in obs.items():
        ref = np.asarray(jobs[k])
        np.testing.assert_allclose(v.numpy(), ref, err_msg=k, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(ref).max(), 1.0))
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), **SENSOR_TOL)
    if task == 'escape':
        rf = obs['rangefinder']
        assert bool(((rf >= -1) & (rf <= 1)).all())


def jenv_task(task):
    return {'walk': jquadruped.Move(jquadruped._WALK_SPEED),
            'run': jquadruped.Move(jquadruped._RUN_SPEED),
            'escape': jquadruped.Escape(),
            'fetch': jquadruped.Fetch(floor_size=15)}[task]


# ---- #1's plain twin at 240 rows --------------------------------------


def test_apgd_plain_240_rows_matches_jax():
    """The cold and warm 240-row solves of two substeps from walk poses in
    contact (4 equality rows, then non-negative rows: 16 limits, 104
    frictionless leg contacts, 29 floor pyramids of 4 facets) on #1's
    global path's shape, the plain twin against JAX's XLA iterate."""
    tm = port_model('walk')
    s, _, u = contact_state('walk', B, 4)
    captured = capture_solves(tm, s, u)
    assert [kw['cold'] for _, kw in captured] == [True, False]
    assert apgd_solve.dense_route(240) == 'global'
    for args, kw in captured:
        assert args[0].shape == (B, 240, 240)
        assert (kw['eq_rows'], kw['nonneg'], kw['box_rows'], kw['con0'],
                kw['iterations']) == ((0, 1, 2, 3), tuple(range(4, 240)),
                                      (), (), 60)
        f, v = apgd_solve.apgd_iterate_batched(
            *[torch.as_tensor(a) for a in args], **kw)
        ref = jax_iterate(args, kw)
        np.testing.assert_allclose(f.numpy(), ref[0], **APGD_TOL)
        np.testing.assert_allclose(v.numpy(), ref[1], **APGD_TOL)
        assert (args[4][:, 20:].sum(1) > 0).all()


# ---- control steps from JAX-drawn resets ------------------------------


def float64_step(task, state, a):
    """The port's control step in float64 (model, state, params, action)."""
    env64 = suite.load('quadruped', task, device='cpu')
    m = env64.model
    f64 = lambda o: dataclasses.replace(o, **{
        f.name: getattr(o, f.name).double() for f in dataclasses.fields(o)
        if isinstance(getattr(o, f.name), torch.Tensor)})
    env64._model = f64(m).replace(opt=f64(m.opt))
    params = (state.params.double() if isinstance(state.params, torch.Tensor)
              else state.params)
    s64 = dataclasses.replace(state, physics=f64(state.physics),
                              params=params)
    return env64.step(s64, torch.as_tensor(a).double())


# fetch's float32 step parts from float64 arithmetic by up to 5.7e-4 in
# qvel and 1.5e-3 in imu in JAX and 4.1e-4 / ~1e-3 in the port (its fresh
# floor contacts' solves stop at the 60 cap), so 1e-4 lies below the
# rounding floor there
STEP_TOLS = {'walk': 1e-4, 'escape': 1e-4, 'fetch': 1e-3}


def assert_step_close(ours, ref, ours64, name, tol):
    """ours against JAX's at atol = rtol = `tol`, and the port's float32
    step no farther from its float64 step than JAX's is (twice that,
    plus 1e-4)."""
    ours, ref, ours64 = (np.asarray(x, np.float64) for x in (ours, ref,
                                                            ours64))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol, err_msg=name)
    e_ours, e_ref = np.abs(ours - ours64).max(), np.abs(ref - ours64).max()
    assert e_ours <= 2 * e_ref + 1e-4, (name, e_ours, e_ref)


@pytest.mark.parametrize('task', [
    pytest.param(t, marks=heavy(
        'JAX compiles a quadruped reset and step in ~60 s and ~75 s on '
        'one core')) for t in ('walk', 'escape', 'fetch')])
def test_control_step_from_jax_reset_matches(task):
    """The FIRST observation and one control step from JAX-drawn resets
    (escape's terrain JAX's) with numpy actions: qpos, qvel, act, reward
    and every observation key (``assert_step_close`` at ``STEP_TOLS``)."""
    jenv = jenv_of('quadruped', task)
    env = suite.load('quadruped', task, device='cpu')
    assert env._n_sub_steps == 4
    jstate, jts = _jax_reset(jenv, B, 9)
    state = _port_state(jstate)
    if task == 'escape':
        assert state.params.shape == (B, 201, 201)
    assert state.physics.act.shape == (B, 12)
    _, ts = env.start(state.physics, state.params)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts.observation[k]),
                                   err_msg=k, **STEP_TOL)
    a = np.random.RandomState(5).uniform(-1, 1, (B, 12)).astype(np.float32)
    j1, jts1 = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(a))
    t1, ts1 = env.step(state, torch.as_tensor(a))
    t64, ts64 = float64_step(task, state, a)
    tol = STEP_TOLS[task]
    for name in ('qpos', 'qvel', 'act'):
        assert_step_close(getattr(t1.physics, name), getattr(j1.physics,
                                                             name),
                          getattr(t64.physics, name), name, tol)
    assert_step_close(ts1.reward, jts1.reward, ts64.reward, 'reward', tol)
    assert list(ts1.observation) == sorted(jts1.observation)
    for k, v in ts1.observation.items():
        assert_step_close(v, jts1.observation[k], ts64.observation[k], k,
                          tol)


@pytest.mark.parametrize('task', TASKS)
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('quadruped', task, port_model(task),
                          *HEAVY_THRESHOLDS[('quadruped', task)])


# ---- the port's resets ------------------------------------------------


def test_port_resets():
    """Unit quaternions, the root 1 cm above the floor's deepest contact,
    zero activations; fetch's azimuth about z, spawn points within 90% of
    the floor, the ball 2 m up and moving in the plane."""
    g = torch.Generator().manual_seed(0)
    for task in ('walk', 'fetch'):
        env = suite.load('quadruped', task, device='cpu')
        m = env.model
        state, ts = env.reset(64, g)
        q = state.physics.qpos
        np.testing.assert_allclose(torch.linalg.vector_norm(
            q[:, 3:7], dim=1).numpy(), 1.0, atol=1e-6)
        assert float(state.physics.act.abs().max()) == 0
        kin = smooth.kinematics(m, q, smooth.tree_meta(m))
        floor = m.name2id('geom', 'floor')
        pairs = [p for p in collision.candidate_pairs(m) if floor in p]
        dist = collision.detect(m, kin[3], kin[4], pairs).dist
        np.testing.assert_allclose(dist.min(1).values.numpy(), .01,
                                   atol=1e-5)
        assert ts.observation['egocentric_state'].shape == (64, 44)
        if task == 'fetch':
            assert float(q[:, 4:6].abs().max()) == 0
            assert float(q[:, :2].abs().max()) <= 13.5
            qa = m.jnt_qposadr[m.name2id('joint', 'ball_root')]
            np.testing.assert_allclose(q[:, qa + 2].numpy(), 2.0)
            assert float(q[:, qa:qa + 2].abs().max()) <= 13.5
            da = m.jnt_dofadr[m.name2id('joint', 'ball_root')]
            v = state.physics.qvel
            assert 3 < float(v[:, da:da + 2].std()) < 7
            assert float(v[:, da + 2:].abs().max()) == 0


def test_autoreset_restarts_with_zero_activations():
    env = suite.load('quadruped', 'walk', device='cpu')
    g = torch.Generator().manual_seed(1)
    state, _ = env.reset(3, g)
    state, _ = env.step(state, torch.ones(3, 12))
    assert float(state.physics.act.abs().min()) > 0
    qpos = state.physics.qpos.clone()
    qpos[1, 0] = float('nan')
    bad = dataclasses.replace(state, physics=state.physics.replace(
        qpos=qpos))
    new, ts = env.autoreset_step(bad, torch.ones(3, 12), g)
    np.testing.assert_array_equal(ts.step_type.numpy(), [1, 0, 1])
    assert float(new.physics.act[1].abs().max()) == 0
    assert float(new.physics.act[0].abs().min()) > 0


def test_registered_as_in_jax():
    from mujoco_mbrl_tpu import suite as jsuite
    ported = set(suite._DOMAINS)
    assert 'quadruped' in ported
    assert suite.all_tasks() == tuple(
        t for t in jsuite.all_tasks() if t[0] in ported)
    assert suite.benchmarking() == tuple(
        t for t in jsuite.benchmarking() if t[0] in ported)
    assert [t for d, t in suite.all_tasks() if d == 'quadruped'] == list(
        TASKS)
    # no wrapper: the JAX package raises NameError there, the port its
    # refusal naming the JAX function
    from mujoco_mbrl_tpu import envs as jenvs
    from mujoco_mbrl_tpu_torch import envs
    with pytest.raises(NameError):
        jenvs.load('quadruped', 'walk')
    with pytest.raises(NotImplementedError, match='EnvWrapper.load'):
        envs.load('quadruped', 'walk', device='cpu')


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    for task in TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load('quadruped', task)
