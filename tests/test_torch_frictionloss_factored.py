"""Friction-loss rows in the factored regime, the port against the JAX package.

The cheetah with ``frictionloss='.1'`` in its ``cheetah`` joint class (the
six leg joints; the root's ``free`` class has none) has 6 box rows before
its 146 contact and limit rows, over nv 9: past 96 rows, so both packages
take the factored regime, with each env's bounds (the friction loss over
that env's row scale) batched (B, 152). JAX then runs its XLA iterate
(``_apgd_dispatch_factored``, whose kernel gate asks for unbatched
bounds); the port runs #7's plain twin on CPU tensors (the kernel on the
card). At 8 envs from joints drawn by jax.random, lowered onto the floor,
the solves the port's steps build (a cold one, then a warm one from its
forces) match JAX's XLA iterate on the same inputs (rtol = atol = 2e-4),
and two physics steps match JAX's steps (qvel within 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import cheetah as jcheetah
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import cheetah

N = 8
CLASS = "<default class='cheetah'>\n      <joint "


def frictionloss_xml(xml):
    """The cheetah XML with frictionloss='.1' in its cheetah joint class."""
    assert xml.count(CLASS) == 1
    return xml.replace(CLASS, CLASS + "frictionloss='.1' ")


@pytest.fixture(scope='module')
def setup():
    xml = frictionloss_xml(cheetah._XML)
    jm, tm = jmjcf.parse(frictionloss_xml(jcheetah._XML)), mjcf.parse(xml)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    lo, hi = jm.jnt_range[3:, 0], jm.jnt_range[3:, 1]
    qpos = np.zeros((N, tm.nq), np.float32)
    qpos[:, 3:] = np.asarray(jax.random.uniform(k1, (N, 6), minval=lo,
                                                maxval=hi))
    qpos[:, 1] = np.asarray(jax.random.uniform(k2, (N,), minval=-0.3,
                                               maxval=-0.15))
    qvel = np.asarray(jax.random.normal(k3, (N, tm.nv)), np.float32)
    captured = []
    real = apgd_solve.apgd_iterate_factored

    def capture(*args, **kw):
        captured.append(([a.numpy().copy() for a in args], dict(kw)))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_factored = capture
    try:
        s = M.State(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
                    time=torch.zeros(N), act=None)
        zero = torch.zeros((N, tm.nu))
        s1, f, v = engine.step_warm(tm, s, zero)
        s2, _, _ = engine.step_warm(tm, s1, zero, warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_factored = real
    return jm, tm, qpos, qvel, captured, s2


def test_model_and_rows(setup):
    jm, tm, _, _, captured, _ = setup
    np.testing.assert_allclose(tm.dof_frictionloss.numpy(),
                               np.asarray(jm.dof_frictionloss))
    assert tm.dof_frictionloss.tolist() == [0, 0, 0] + [pytest.approx(.1)] * 6
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape == (N, 152, 9)
        assert kw['box_rows'] == tuple(range(6))
        assert args[9].shape == (N, 152)          # per-env bounds
        assert apgd_solve.factored_route(152, 9) == 'warp'
        bnd = args[9][:, :6]
        assert (bnd > 0).all() and np.ptp(bnd, axis=0).max() > 0
        assert (args[9][:, 6:] == 0).all()


@pytest.mark.parametrize('cold', [True, False], ids=['cold', 'warm'])
def test_solves_match_jax_xla_iterate(setup, cold):
    _, _, _, _, captured, _ = setup
    (args, kw), = [c for c in captured if c[1]['cold'] == cold]
    cv = jsolver._apgd_dispatch_factored(kw['nonneg'], kw['box_rows'],
                                         kw['con0'], kw['iterations'], cold)
    fn = jax.jit(jax.vmap(cv, in_axes=(0,) * 8 + (None, 0)))
    with jax.default_matmul_precision('highest'):
        ref = [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]
    ours = apgd_solve.apgd_iterate_factored(
        *[torch.as_tensor(a) for a in args], **kw)
    assert np.abs(ref[0][:, :6]).max() > 1e-3, 'no friction-loss force'
    assert np.abs(ref[0]).max() < 1e6
    for o, r, name in zip(ours, ref, ('f', 'v')):
        np.testing.assert_allclose(o.numpy(), r, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    # a box row's force stays within its env's bound (in scaled units)
    f = ours[0].numpy()[:, :6]
    assert (np.abs(f) <= args[9][:, :6] * (1 + 1e-6)).all()


def test_two_steps_match_jax(setup):
    jm, _, qpos, qvel, _, s2 = setup

    def run(q, v):
        s = JM.State(qpos=q, qvel=v, time=jnp.zeros(()), act=None)
        s1, f, w = jengine.step_warm(jm, s, jnp.zeros(jm.nu))
        return jengine.step_warm(jm, s1, jnp.zeros(jm.nu), warm_f=f,
                                 warm_v=w)[0]

    out = jax.jit(jax.vmap(run))(jnp.asarray(qpos), jnp.asarray(qvel))
    np.testing.assert_allclose(s2.qvel.numpy(), np.asarray(out.qvel),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s2.qpos.numpy(), np.asarray(out.qpos),
                               rtol=1e-5, atol=1e-5)
