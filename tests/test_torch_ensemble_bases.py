"""``EnsembleDynamics`` over non-MLP bases, the port against the JAX package.

JAX's ensemble vmaps its base over the members' stacked parameters, so
it takes any base whose ``init``, ``forward`` and ``loss`` map: a
``LinearDynamics`` ensemble's JAX parameters, carried across by
``convert.ensemble_params``, give the same ``forward``, ``forward_all``,
``forward_ts`` (row k -> member k % n; the mean when n does not divide
the rows) and ``loss`` (1e-5); with a generator each member's loss reads
its own bootstrap resample. Where JAX fails, the port fails with the same
exception type: a ``RewardDynamics`` base has no ``noise`` (the
constructor reads it), and an ``RNNDynamics`` base's forward binds the
normalizers to its hidden state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.models import dynamics as JD
from mujoco_mbrl_tpu_torch import convert
from mujoco_mbrl_tpu_torch.models import dynamics as D

SD, AD, NE = 8, 3, 5


def _norms(rng):
    j = JD.Normalizers(
        state_mean=jnp.asarray(rng.normal(size=SD), jnp.float32),
        state_std=jnp.asarray(rng.uniform(0.5, 2, SD), jnp.float32),
        action_mean=jnp.asarray(rng.normal(size=AD), jnp.float32),
        action_std=jnp.asarray(rng.uniform(0.5, 2, AD), jnp.float32))
    return j, convert.normalizers(j)


@pytest.fixture(scope='module')
def linear():
    jens = JD.EnsembleDynamics(JD.LinearDynamics(SD, AD), NE)
    jp = jens.init(jax.random.PRNGKey(0))
    tens = D.EnsembleDynamics(D.LinearDynamics(SD, AD), NE)
    return jens, jp, tens, convert.ensemble_params(jp)


def test_params_carry_a_member_axis(linear):
    jens, jp, tens, tp = linear
    assert tuple(tp['l1']['w'].shape) == (NE, SD + AD, SD)
    ours = tens.init(torch.Generator().manual_seed(0), device='cpu')
    assert {k: {q: tuple(v.shape) for q, v in d.items()}
            for k, d in ours.items()} == {
        k: {q: tuple(v.shape) for q, v in d.items()} for k, d in tp.items()}


@pytest.mark.parametrize('rows', [20, 23], ids=['divisible', 'mean'])
def test_linear_ensemble_forwards_match_jax(linear, rows):
    jens, jp, tens, tp = linear
    rng = np.random.RandomState(rows)
    jn, tn = _norms(rng)
    s = rng.normal(size=(rows, SD)).astype(np.float32)
    a = rng.normal(size=(rows, AD)).astype(np.float32)
    js, ja, ts, ta = jnp.asarray(s), jnp.asarray(a), torch.tensor(s), \
        torch.tensor(a)
    for name in ('forward', 'forward_all', 'forward_ts'):
        ref = np.asarray(getattr(jens, name)(jp, js, ja, jn))
        ours = getattr(tens, name)(tp, ts, ta, tn).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    if rows % NE == 0:
        # row k is member k % n's prediction
        member = lambda i: {k: {q: v[i] for q, v in d.items()}
                            for k, d in tp.items()}
        one = tens.base.forward(member(2), ts[2::NE], ta[2::NE], tn)
        np.testing.assert_allclose(tens.forward_ts(tp, ts, ta, tn)[2::NE],
                                   one, rtol=1e-6, atol=1e-6)


def test_linear_ensemble_loss_matches_jax(linear):
    jens, jp, tens, tp = linear
    rng = np.random.RandomState(7)
    jn, tn = _norms(rng)
    batch = {k: rng.normal(size=(16, 4, d)).astype(np.float32)
             for k, d in (('states', SD), ('actions', AD),
                          ('next_states', SD))}
    ref = float(jens.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jn))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    ours = float(tens.loss(tp, tb, tn))
    assert ours == pytest.approx(ref, rel=1e-5)
    # bootstrap: each member's own resample of every field of the batch
    g = torch.Generator().manual_seed(3)
    boot = tens.loss(tp, tb, tn, generator=g)
    idx = torch.randint(0, 16, (NE, 16),
                        generator=torch.Generator().manual_seed(3))
    member = lambda i: {k: {q: v[i] for q, v in d.items()}
                        for k, d in tp.items()}
    want = sum(float(tens.base.loss(member(i), {k: v[idx[i]] for k, v in
                                                tb.items()}, tn))
               for i in range(NE))
    assert float(boot) == pytest.approx(want, rel=1e-6)
    assert float(boot) != pytest.approx(ours, rel=1e-3)


def test_linear_ensemble_trains_by_autograd(linear):
    _, _, tens, tp = linear
    p = {k: {q: v.clone().requires_grad_() for q, v in d.items()}
         for k, d in tp.items()}
    rng = np.random.RandomState(1)
    tb = {k: torch.tensor(rng.normal(size=(8, 2, d)).astype(np.float32))
          for k, d in (('states', SD), ('actions', AD), ('next_states', SD))}
    tens.loss(p, tb).backward()
    assert all(bool(v.grad.abs().sum() > 0) for d in p.values()
               for v in d.values())


def _raised(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 -- compared below
        return type(e)
    return None


def test_reward_base_fails_as_in_jax():
    jerr = _raised(lambda: JD.EnsembleDynamics(JD.RewardDynamics(SD, AD), 3))
    terr = _raised(lambda: D.EnsembleDynamics(D.RewardDynamics(SD, AD), 3))
    assert jerr is AttributeError and terr is jerr


def test_rnn_base_fails_as_in_jax():
    jens = JD.EnsembleDynamics(JD.RNNDynamics(SD, AD, 16), 3)
    tens = D.EnsembleDynamics(D.RNNDynamics(SD, AD, 16), 3)
    jp = jens.init(jax.random.PRNGKey(1))
    tp = tens.init(torch.Generator().manual_seed(1), device='cpu')
    assert tuple(tp['gru_rz']['w'].shape) == tuple(jp['gru_rz']['w'].shape)
    jerr = _raised(lambda: jens.forward(jp, jnp.zeros((6, SD)),
                                        jnp.zeros((6, AD))))
    terr = _raised(lambda: tens.forward(tp, torch.zeros((6, SD)),
                                        torch.zeros((6, AD))))
    assert jerr is TypeError and terr is jerr


def test_linear_ensemble_plans_through_the_scan(linear):
    """A non-MLP ensemble has no fused sampler (the agent's gate asks for
    an MLP base, as JAX's does): the batched CEM costs its candidates by
    the model / cost scan over forward_ts."""
    from mujoco_mbrl_tpu_torch.planners import shooting

    _, _, tens, tp = linear
    s0 = torch.tensor(np.random.RandomState(2).normal(size=(3, SD)),
                      dtype=torch.float32)
    traj = shooting.cem_batched(
        [1, 2], s0, 4, AD, num_candidates=10, num_elites=3,
        model=lambda s, a: tens.forward_ts(tp, s, a),
        cost=lambda s, a: (s * s).sum(-1) + (a * a).sum(-1))
    actions = traj.actions
    assert tuple(actions.shape) == (4, 3, AD)
    assert bool(torch.isfinite(actions).all())
    assert float(actions.abs().max()) <= 1.0
