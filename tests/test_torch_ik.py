"""Inverse kinematics, port against the JAX package (physics/ik.py).

swimmer6's 'head' site (planar root + hinge chain), as JAX's
tests/test_ik.py: from the same qpos0 and target both solvers run 100
damped least-squares steps; qpos agrees within 1e-4 and both place the
site within 2e-3 of the target. The site Jacobian agrees with JAX's
within 1e-5 at random configurations, and a batch of targets solves
each env as a solve of its own would.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mujoco_mbrl_tpu.physics import ik as jik
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.suite import swimmer as jswimmer
from mujoco_mbrl_tpu_torch.physics import ik, mjcf, smooth
from mujoco_mbrl_tpu_torch.suite import swimmer

REACH = 2e-3         # the site's distance to the target (JAX's test)
QPOS_TOL = 1e-4      # port against JAX, qpos after 100 steps


@pytest.fixture(scope='module')
def models():
    xml = swimmer._make_model_xml(6)
    assert xml == jswimmer._make_model_xml(6)
    return mjcf.parse(xml), jmjcf.parse(xml)


def _head(m, qpos):
    """(B, 3) world position of the head site at qpos (B, nq)."""
    out = smooth.kinematics(m, qpos, smooth.tree_meta(m))
    return out[5][:, m.name2id('site', 'head')]


def _target_qpos(m):
    """JAX's test pose: the root moved and one hinge bent."""
    q = m.qpos0.clone()
    q[0] += 0.15
    q[1] -= 0.1
    q[3] = 0.4
    return q


def test_qpos_from_site_pose_matches_jax(models):
    m, jm = models
    target = _head(m, _target_qpos(m)[None])[0]
    q, err = ik.qpos_from_site_pose(m, 'head', target, max_steps=100)
    jq, jerr = jik.qpos_from_site_pose(jm, 'head',
                                       jnp.asarray(target.numpy()),
                                       max_steps=100)
    np.testing.assert_allclose(q[0].numpy(), np.asarray(jq), atol=QPOS_TOL,
                               rtol=0)
    assert float(err[0]) < REACH and float(jerr) < REACH
    np.testing.assert_allclose(_head(m, q)[0].numpy(), target.numpy(),
                               atol=REACH)
    jmeta = jsmooth.tree_meta(jm)
    reached = jsmooth.kinematics(jm, jq, jmeta)[5][jm.name2id('site',
                                                             'head')]
    np.testing.assert_allclose(np.asarray(reached), target.numpy(),
                               atol=REACH)


def test_site_jacobian_matches_jax(models):
    m, jm = models
    rng = np.random.default_rng(0)
    qpos = torch.tensor(np.asarray(m.qpos0) + rng.normal(0, 0.3, (4, m.nq)),
                        dtype=torch.float32)
    sid = m.name2id('site', 'head')
    J, pos = ik.site_jacobian(m, qpos, sid)
    assert J.shape == (4, 3, m.nv)
    for b in range(4):
        jJ, jpos = jik.site_jacobian(jm, jnp.asarray(qpos[b].numpy()), sid)
        np.testing.assert_allclose(J[b].numpy(), np.asarray(jJ), atol=1e-5)
        np.testing.assert_allclose(pos[b].numpy(), np.asarray(jpos),
                                   atol=1e-6)


def test_batched_targets_solve_as_single_solves(models):
    """Three targets in one batch: each env's qpos equals its own
    one-env solve (rtol 1e-5) and reaches its target."""
    m, _ = models
    rng = np.random.default_rng(1)
    poses = m.qpos0 + torch.tensor(rng.normal(0, 0.2, (3, m.nq)),
                                   dtype=torch.float32)
    targets = _head(m, poses)
    q, err = ik.qpos_from_site_pose(m, 'head', targets, max_steps=60)
    assert q.shape == (3, m.nq) and err.shape == (3,)
    for b in range(3):
        qb, _ = ik.qpos_from_site_pose(m, 'head', targets[b], max_steps=60)
        np.testing.assert_allclose(q[b].numpy(), qb[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_head(m, q).numpy(), targets.numpy(),
                               atol=REACH)


def test_free_joint_turns_on_the_sphere():
    """A free-floating arm: the solve moves the root's quaternion, which
    stays unit length (``engine.integrate_pos``)."""
    xml = """<mujoco><worldbody><body name='root' pos='0 0 1'>
      <freejoint name='free'/><geom type='sphere' size='.1'/>
      <body name='arm' pos='.2 0 0'>
        <joint name='elbow' type='hinge' axis='0 1 0'/>
        <geom type='capsule' fromto='0 0 0 .3 0 0' size='.04'/>
        <site name='hand' pos='.3 0 0'/></body></body></worldbody></mujoco>"""
    m = mjcf.parse(xml)
    target = torch.tensor([0.3, 0.2, 1.3])
    q, err = ik.qpos_from_site_pose(m, 'hand', target, max_steps=80)
    sid = m.name2id('site', 'hand')
    pos = smooth.kinematics(m, q, smooth.tree_meta(m))[5][:, sid]
    np.testing.assert_allclose(pos[0].numpy(), target.numpy(), atol=REACH)
    np.testing.assert_allclose(q[0, 3:7].norm().item(), 1.0, atol=1e-5)
