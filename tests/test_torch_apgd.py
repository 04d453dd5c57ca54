"""APGD iterate port (ops.apgd_solve plain version) against the JAX package.

The port's plain version — what the CUDA kernel is held to on the card —
is compared with the JAX Pallas kernel in interpret mode
(``apgd_iterate_batched(..., interpret=True)``) and with the XLA iterate
(``physics.solver._apgd_dispatch`` under vmap) on the same numpy inputs:
synthetic problems with non-negative, box, cone and equality rows, cold
and warm, and a problem captured from the port's own walker solve.
Tolerance rtol = atol = 2e-4, as tests/test_apgd_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.ops import apgd_solve as japgd
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import walker

NONNEG = (0, 1, 2)
BOX = (3,)
CON0 = (5, 8, 11, 14)
NR = 17
TOL = dict(rtol=2e-4, atol=2e-4)


def _problem(seed, B, nr=NR):
    """Random unit-diagonal PSD dual QP batch (numpy, float32)."""
    rng = np.random.RandomState(seed)
    G = rng.normal(size=(B, nr + 4, nr))
    A = np.einsum('bij,bik->bjk', G, G) / (nr + 4) + 0.05 * np.eye(nr)
    s = 1.0 / np.sqrt(np.diagonal(A, axis1=1, axis2=2))
    Ad = A * s[:, :, None] * s[:, None, :]
    rhs = rng.normal(size=(B, nr))
    f0 = 0.3 * rng.normal(size=(B, nr))
    v0 = rng.normal(size=(B, nr))
    active = (rng.uniform(size=(B, nr)) > 0.15).astype(np.float64)
    mu = np.zeros(nr)
    bounds = np.zeros(nr)
    if nr == NR:
        mu[list(CON0)] = [0.6, 0.8, 1.0, 0.5]
        bounds[list(BOX)] = 0.7
    return tuple(np.asarray(x, np.float32)
                 for x in (Ad, rhs, f0, v0, active, mu, bounds))


def _jax_xla(args, nonneg, box, con0, iterations, cold, eq_rows):
    cv = jsolver._apgd_dispatch(nonneg, box, con0, iterations, cold, eq_rows)
    B = args[0].shape[0]
    fn = jax.jit(lambda a: jax.vmap(cv)(*a[:5], *[
        jnp.broadcast_to(x, (B,) + x.shape) for x in a[5:]]))
    with jax.default_matmul_precision('highest'):
        return [np.asarray(x) for x in fn(tuple(jnp.asarray(a)
                                                for a in args))]


def _jax_pallas(args, nonneg, box, con0, iterations, cold, eq_rows):
    out = japgd.apgd_iterate_batched(
        *[jnp.asarray(a) for a in args], nonneg=nonneg, box_rows=box,
        con0=con0, iterations=iterations, cold=cold, eq_rows=eq_rows,
        interpret=True)
    return [np.asarray(x) for x in out]


def _port(args, nonneg, box, con0, iterations, cold, eq_rows):
    out = apgd_solve.apgd_iterate_batched(
        *[torch.as_tensor(a) for a in args], nonneg=nonneg, box_rows=box,
        con0=con0, iterations=iterations, cold=cold, eq_rows=eq_rows)
    return [x.numpy() for x in out]


@pytest.mark.parametrize('cold', [True, False])
@pytest.mark.parametrize('eq_rows', [(), (4,)])
def test_plain_matches_jax_kernel_and_xla(cold, eq_rows):
    args = _problem(0 if cold else 1, B=37)
    kw = dict(nonneg=NONNEG, box=BOX, con0=CON0, iterations=40, cold=cold,
              eq_rows=eq_rows)
    f, v = _port(args, **kw)
    for ref in (_jax_xla(args, **kw), _jax_pallas(args, **kw)):
        np.testing.assert_allclose(f, ref[0], **TOL)
        np.testing.assert_allclose(v, ref[1], **TOL)


def test_plain_limits_only():
    """Non-negative rows only (the cone and box code paths off)."""
    args = _problem(2, B=16, nr=4)
    kw = dict(nonneg=(0, 1, 2, 3), box=(), con0=(), iterations=30,
              cold=True, eq_rows=())
    f, v = _port(args, **kw)
    ref = _jax_xla(args, **kw)
    np.testing.assert_allclose(f, ref[0], **TOL)
    np.testing.assert_allclose(v, ref[1], **TOL)


def _walker_captured():
    """Inputs of the port's walker solve at states in contact: the cold
    first solve and the warm one after it."""
    tm = mjcf.parse(walker._XML)
    rng = np.random.RandomState(4)
    B = 5
    qpos = np.zeros((B, tm.nq), np.float32)
    qpos[:, 0] = rng.uniform(-1.1, -0.6, B)
    qpos[:, 2] = rng.uniform(-0.5, 0.5, B)
    qpos[:, 3:] = rng.uniform(-0.4, 0.4, (B, 6))
    state = State(qpos=torch.as_tensor(qpos),
                  qvel=torch.as_tensor(rng.normal(size=(B, tm.nv)),
                                       dtype=torch.float32),
                  time=torch.zeros(B))
    captured = []
    real = apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append(([a.numpy().copy() for a in args], dict(kw)))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_batched = capture
    try:
        state, f, v = engine.step_warm(tm, state, torch.zeros(B, tm.nu))
        engine.step_warm(tm, state, torch.zeros(B, tm.nu), warm_f=f,
                         warm_v=v)
    finally:
        apgd_solve.apgd_iterate_batched = real
    return captured


def test_plain_matches_jax_on_walker_solve():
    captured = _walker_captured()
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape[1:] == (62, 62)
        assert args[4].sum() > 10, 'walker problem without active rows'
        jkw = dict(nonneg=kw['nonneg'], box=kw['box_rows'],
                   con0=kw['con0'], iterations=kw['iterations'],
                   cold=kw['cold'], eq_rows=kw['eq_rows'])
        f, v = _port(tuple(args), **jkw)
        refs = [_jax_xla(tuple(args), **jkw)]
        if kw['cold']:        # one interpret-mode run keeps the file quick
            refs.append(_jax_pallas(tuple(args), **jkw))
        for ref in refs:
            np.testing.assert_allclose(f, ref[0], **TOL)
            np.testing.assert_allclose(v, ref[1], **TOL)
