"""Ball joints and velocity servos of the port against the JAX package.

The model is chip_smoke.py's path 54 (``BALL_CHAIN_XML``, held identical
there): a base hung from the world on a limited ball joint, a capsule on
a hinge driven by a ``<velocity>`` actuator, a capsule on a second ball
joint, a floor the chain reaches, and a ``<sensor>`` and a
``<contact><pair>`` that both compilers drop. Same inputs, drawn with
numpy, go through both packages: the Model field by field (the ball
joints' qpos0 and invweights, the servo's gain and bias), kinematics
(xpos and xquat within 1e-5), cdof and cdof_dot, qacc, and 10 Euler and
10 RK4 steps (qvel within 1e-4); ``named`` indexes a ball joint as JAX's
does; the randomizer draws unit quaternions within the joint's limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import named as jnamed
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu_torch.physics import engine, mjcf, named, smooth
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import randomizers

BALL_CHAIN_XML = """
<mujoco model='ball_chain'>
  <option timestep='0.005'/>
  <default><geom friction='0.8 0.01 0.001'/></default>
  <worldbody>
    <geom name='floor' type='plane' size='3 3 .1'/>
    <body name='base' pos='0 0 0.65'>
      <joint name='hang' type='ball' limited='true' range='0 60'
             damping='0.5'/>
      <geom name='base' type='capsule' fromto='0 0 0 0 0 -0.3'
            size='0.05'/>
      <body name='arm' pos='0 0 -0.3'>
        <joint name='elbow' type='hinge' axis='0 1 0' damping='0.1'/>
        <geom name='arm' type='capsule' fromto='0 0 0 0.3 0 -0.2'
              size='0.04'/>
        <body name='tip' pos='0.3 0 -0.2'>
          <joint name='wrist' type='ball' damping='0.05'/>
          <geom name='tip' type='capsule' fromto='0 0 0 0 0 -0.35'
                size='0.04'/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <velocity name='spin' joint='elbow' kv='3' ctrllimited='true'
              ctrlrange='-2 2'/>
  </actuator>
  <contact><pair geom1='floor' geom2='tip'/></contact>
  <sensor><jointvel name='elbow_vel' joint='elbow'/></sensor>
</mujoco>
"""
N = 6


@pytest.fixture(scope='module')
def models():
    return jmjcf.parse(BALL_CHAIN_XML), mjcf.parse(BALL_CHAIN_XML)


def test_model_string_is_chip_smoke_path_54():
    assert chip_smoke.BALL_CHAIN_XML == BALL_CHAIN_XML


def compare_models(jm, tm):
    """Every field of the port's Model against JAX's (opt by name)."""
    for f in dataclasses.fields(tm):
        ours, ref = getattr(tm, f.name), getattr(jm, f.name, None)
        if f.name == 'opt':
            for name in ('timestep', 'gravity', 'viscosity', 'density',
                         'wind'):
                np.testing.assert_allclose(getattr(ours, name).numpy(),
                                           np.asarray(getattr(ref, name)))
            for name in ('integrator', 'disableflags', 'solver_iterations',
                         'solver', 'cone', 'impratio', 'solver_warmstart'):
                assert getattr(ours, name) == getattr(ref, name), name
        elif isinstance(ours, torch.Tensor):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6, err_msg=f.name)
        elif f.name == 'names':
            for kind, table in ours.items():
                assert table == ref.get(kind, {}), kind
        elif ours is None or ref is None:
            assert ours is None and ref is None, f.name
        else:
            assert ours == ref, f.name


def test_parse_matches_jax(models):
    jm, tm = models
    compare_models(jm, tm)
    assert (tm.nq, tm.nv, tm.nu) == (9, 7, 1)
    np.testing.assert_array_equal(tm.qpos0.numpy(),
                                  [1, 0, 0, 0, 0, 1, 0, 0, 0])
    np.testing.assert_allclose(tm.jnt_range[0].numpy(), [0, np.pi / 3])
    np.testing.assert_array_equal(tm.actuator_gainprm[0].numpy(), [3, 0, 0])
    np.testing.assert_array_equal(tm.actuator_biasprm[0].numpy(),
                                  [0, 0, -3])
    assert tm.actuator_biastype == (M.BIAS_AFFINE,)
    iw = tm.dof_invweight0.numpy()
    assert iw[0] == iw[1] == iw[2] and iw[4] == iw[5] == iw[6]


def _inputs(tm, seed):
    rng = np.random.RandomState(seed)
    qpos = np.zeros((N, tm.nq), np.float32)
    for adr in (0, 5):
        q = rng.normal(size=(N, 4))
        q[:, 0] = np.abs(q[:, 0]) + 1.0
        qpos[:, adr:adr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 4] = rng.uniform(-1.0, 1.0, N)
    qvel = rng.normal(0.0, 1.0, (N, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-3.0, 3.0, (N, tm.nu)).astype(np.float32)
    return qpos, qvel, ctrl


def test_kinematics_cdof_and_qacc(models):
    jm, tm = models
    qpos, qvel, ctrl = _inputs(tm, 0)
    jmeta, tmeta = jsmooth.tree_meta(jm), smooth.tree_meta(tm)

    def jkin(q, v, c):
        xpos, xquat, _, _, _, _, xanchor, xaxis = jsmooth.kinematics(
            jm, q, jmeta)
        cdof = jsmooth.motion_subspace(jm, xquat, xanchor, xaxis, jmeta)
        _, cdof_dot = jsmooth.velocities(jm, v, cdof, jmeta)
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(()),
                                         act=None), c)
        return xpos, xquat, cdof, cdof_dot, d.qacc, d.qfrc_actuator

    ref = [np.asarray(x) for x in jax.jit(jax.vmap(jkin))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))]
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    xpos, xquat, _, _, _, _, xanchor, xaxis = smooth.kinematics(tm, q, tmeta)
    cdof = smooth.motion_subspace(tm, xquat, xanchor, xaxis, tmeta)
    _, cdof_dot = smooth.velocities(tm, v, cdof, tmeta)
    d = engine.forward(tm, M.State(qpos=q, qvel=v, time=torch.zeros(N),
                                   act=None), torch.tensor(ctrl))
    ours = [xpos, xquat, cdof, cdof_dot, d.qacc, d.qfrc_actuator]
    for name, o, r, tol in zip(
            ('xpos', 'xquat', 'cdof', 'cdof_dot', 'qacc', 'qfrc_actuator'),
            ours, ref, (1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(o.numpy(), r, rtol=tol, atol=tol,
                                   err_msg=name)
    # the velocity servo: -kv (qvel - ctrl) on the hinge
    np.testing.assert_allclose(d.qfrc_actuator[:, 3].numpy(),
                               3.0 * (np.clip(ctrl[:, 0], -2, 2)
                                      - qvel[:, 3]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('integrator', [JM.EULER, JM.RK4],
                         ids=['euler', 'rk4'])
def test_ten_steps_match_jax(models, integrator):
    jm, tm = models
    jm = jm.replace(opt=jm.opt.replace(integrator=integrator))
    tm = tm.replace(opt=dataclasses.replace(tm.opt, integrator=integrator))
    qpos, qvel, ctrl = _inputs(tm, 1)

    def jrun(q, v, c):
        s = JM.State(qpos=q, qvel=v, time=jnp.zeros(()), act=None)
        s, _ = jax.lax.scan(lambda s, _: (jengine.step(jm, s, c), None), s,
                            None, length=10)
        xpos, xquat = jsmooth.kinematics(jm, s.qpos,
                                         jsmooth.tree_meta(jm))[:2]
        return s.qpos, s.qvel, xpos, xquat

    ref = [np.asarray(x) for x in jax.jit(jax.vmap(jrun))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))]
    s = M.State(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
                time=torch.zeros(N), act=None)
    for _ in range(10):
        s = engine.step(tm, s, torch.tensor(ctrl))
    xpos, xquat = smooth.kinematics(tm, s.qpos, smooth.tree_meta(tm))[:2]
    np.testing.assert_allclose(s.qvel.numpy(), ref[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.qpos.numpy(), ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xpos.numpy(), ref[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xquat.numpy(), ref[3], rtol=1e-5, atol=1e-5)
    # the quaternions stay unit
    for adr in (0, 5):
        n = torch.linalg.vector_norm(s.qpos[:, adr:adr + 4], dim=1)
        assert float((n - 1).abs().max()) < 1e-5


def test_named_indexes_a_ball_joint_as_jax(models):
    jm, tm = models
    qpos, qvel, _ = _inputs(tm, 2)
    js = JM.State(qpos=jnp.asarray(qpos[0]), qvel=jnp.asarray(qvel[0]),
                  time=jnp.zeros(()), act=None)
    ts = M.State(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
                 time=torch.zeros(N), act=None)
    jb, tb = jnamed.indexer(jm).bind(state=js), named.indexer(tm).bind(
        state=ts)
    for name in ('hang', 'elbow', 'wrist'):
        np.testing.assert_array_equal(tb.qpos[name][0].numpy(),
                                      np.asarray(jb.qpos[name]))
        np.testing.assert_array_equal(tb.qvel[name][0].numpy(),
                                      np.asarray(jb.qvel[name]))
    assert tuple(tb.qpos['wrist'].shape) == (N, 4)
    assert tuple(tb.qvel['hang'].shape) == (N, 3)


def test_randomizer_draws_limited_unit_quaternions(models):
    _, tm = models
    B = 4096
    g = torch.Generator().manual_seed(0)
    q = randomizers.randomize_limited_and_rotational_joints(
        tm, tm.qpos0.expand(B, tm.nq).clone(), g)
    hang, wrist = q[:, 0:4], q[:, 5:9]
    for quat in (hang, wrist):
        assert float((torch.linalg.vector_norm(quat, dim=1) - 1).abs().max()
                     ) < 1e-5
    # the limited joint turns by at most its 60 degrees, about uniformly
    angle = 2 * torch.acos(hang[:, 0].clamp(-1, 1))
    assert float(angle.max()) <= np.pi / 3 + 1e-5
    assert abs(float(angle.mean()) - np.pi / 6) < 0.02
    # its axis is uniform on the sphere: each component's mean near 0
    turned = angle > 0.1
    axis = hang[turned, 1:] / torch.sin(angle[turned] / 2)[:, None]
    assert float(axis.mean(0).abs().max()) < 0.05
    # the free ball joint: uniform on S^3, w of either sign
    assert 0.4 < float((wrist[:, 0] > 0).double().mean()) < 0.6
    assert float(wrist.mean(0).abs().max()) < 0.05
    # the hinge is unlimited: uniform in (-pi, pi)
    assert float(q[:, 4].abs().max()) <= np.pi
    assert float(q[:, 4].std()) > 1.5
