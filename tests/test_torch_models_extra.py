"""The linear, reward and RNN dynamics models and the MLP's output noise,
port vs JAX.

* Carry-over: JAX-initialised parameters through ``convert.dense_params``
  (the port's own ``init`` gives the same tree shapes).
* ``forward`` (and ``rollout`` for the RNN) on the same inputs with and
  without normalizers, rtol 1e-5 / atol 1e-6; ``loss`` likewise, with the
  reward model's (loss, aux) pair and the RNN's teacher-forced windows.
* A few fit steps: ``fit_epoch`` fed the JAX package's own epoch indices
  (reproduced from the key splits of ``models/train.py``) against JAX's
  ``train_model``, per-minibatch losses at rtol 1e-4 and parameters at
  rtol 1e-4 / atol 1e-5 (float32 Adam over 2 epochs).
* The output noise is applied only with a random source, in normalized
  space: its draws are held by their moments (4 sigma).
* The RNN called as the JAX agents call it, ``forward(params, s, a,
  normalizers)``, fails with a TypeError on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu.data import replay as JR
from mujoco_mbrl_tpu.models import train as JT
from mujoco_mbrl_tpu_torch import convert, models
from mujoco_mbrl_tpu_torch.data import replay as R
from mujoco_mbrl_tpu_torch.models import train as T

CAP, LEN, SD, AD, N = 4, 6, 5, 2, 7
RTOL, ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def buffers():
    """A JAX buffer and its carried port copy, 4 rollouts of 6 steps."""
    rng = np.random.RandomState(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    rolls = JR.Rollouts(states=f(CAP, LEN + 1, SD) * 2 + 1,
                        observations=f(CAP, LEN + 1, SD) * 1.5 - 0.5,
                        actions=np.clip(f(CAP, LEN, AD), -1, 1),
                        rewards=f(CAP, LEN) * 0.3 + 0.2)
    jbuf = JR.add_rollouts(JR.init_replay(CAP, LEN, SD, SD, AD),
                           jax.tree_util.tree_map(jnp.asarray, rolls))
    tbuf = R.add_rollouts(R.init_replay(CAP, LEN, SD, SD, AD, device='cpu'),
                          convert.rollouts(rolls))
    return jbuf, tbuf


def _inputs(seed, lead=(N,)):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=lead + (SD,)).astype(np.float32),
            rng.uniform(-1, 1, lead + (AD,)).astype(np.float32))


FAMILIES = {
    'lin': (lambda: jmodels.LinearDynamics(SD, AD),
            lambda: models.LinearDynamics(SD, AD), ('l1',)),
    'rw': (lambda: jmodels.RewardDynamics(SD, AD, hidden_units=12),
           lambda: models.RewardDynamics(SD, AD, hidden_units=12),
           convert.REWARD_LAYERS),
    'rnn': (lambda: jmodels.RNNDynamics(SD, AD, hidden_units=9),
            lambda: models.RNNDynamics(SD, AD, hidden_units=9),
            convert.RNN_LAYERS),
}


def _pair(kind, seed=3):
    jm, tm, layers = (f() if callable(f) else f for f in FAMILIES[kind])
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.dense_params(_np(jp), layers)
    own = tm.init(torch.Generator().manual_seed(0), device='cpu')
    assert {k: {kk: v.shape for kk, v in d.items()} for k, d in own.items()
            } == {k: {kk: v.shape for kk, v in d.items()}
                  for k, d in tp.items()}
    return jm, jp, tm, tp


@pytest.mark.parametrize('normalized', [False, True])
@pytest.mark.parametrize('kind', ['lin', 'rw'])
def test_forward_matches_jax(buffers, kind, normalized):
    jbuf, tbuf = buffers
    jm, jp, tm, tp = _pair(kind)
    jn = JT.make_normalizers(jbuf) if normalized else None
    tn = T.make_normalizers(tbuf) if normalized else None
    s, a = _inputs(1)
    jout = jm.forward(jp, jnp.asarray(s), jnp.asarray(a), jn)
    tout = tm.forward(tp, torch.as_tensor(s), torch.as_tensor(a), tn)
    if kind == 'rw':
        assert tout[1].shape == (N, 1)
    for j, t in zip(jax.tree_util.tree_leaves(jout),
                    (tout if isinstance(tout, tuple) else (tout,))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def _window_batch(jbuf, tbuf, horizon, seed=2):
    ri, st = JR.epoch_batches(jbuf, jax.random.PRNGKey(seed), 8, horizon)
    jwin = JR.gather_windows(jbuf, ri[0], st[0], horizon)
    twin = R.gather_windows(tbuf, torch.as_tensor(np.asarray(ri[0])),
                            torch.as_tensor(np.asarray(st[0])), horizon)
    return (JT._batch_from_windows(jwin, True),
            T._batch_from_windows(twin, True))


@pytest.mark.parametrize('kind,horizon', [('lin', 1), ('rw', 1), ('rw', 3),
                                          ('rnn', 1), ('rnn', 4)])
def test_loss_matches_jax(buffers, kind, horizon):
    jbuf, tbuf = buffers
    jm, jp, tm, tp = _pair(kind)
    jb, tb = _window_batch(jbuf, tbuf, horizon)
    jout = jm.loss(jp, jb, JT.make_normalizers(jbuf))
    tout = tm.loss(tp, tb, T.make_normalizers(tbuf))
    if kind == 'rw':
        assert set(tout[1]) == {'state_loss', 'reward_loss'}
        for k in tout[1]:
            np.testing.assert_allclose(float(tout[1][k]),
                                       float(jout[1][k]), rtol=1e-5)
        jout, tout = jout[0], tout[0]
    np.testing.assert_allclose(float(tout), float(jout), rtol=1e-5)


def test_rnn_forward_and_rollout_match_jax(buffers):
    jbuf, tbuf = buffers
    jm, jp, tm, tp = _pair('rnn')
    jn, tn = JT.make_normalizers(jbuf), T.make_normalizers(tbuf)
    s, a = _inputs(4)
    h = np.random.RandomState(5).normal(size=(N, 9)).astype(np.float32)
    js, jh = jm.forward(jp, jnp.asarray(s), jnp.asarray(a), jnp.asarray(h),
                        jn)
    ts, th = tm.forward(tp, torch.as_tensor(s), torch.as_tensor(a),
                        torch.as_tensor(h), tn)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    acts = np.random.RandomState(6).uniform(-1, 1, (5, N, AD)).astype(
        np.float32)
    jr = jm.rollout(jp, jnp.asarray(s), jnp.asarray(acts), jn)
    tr = tm.rollout(tp, torch.as_tensor(s), torch.as_tensor(acts), tn)
    assert tr.shape == (5, N, SD)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    assert tm.init_hidden((2, 3), 'cpu').shape == (2, 3, 9)


def _jax_epoch_indices(jbuf, key, num_epochs, batch_size, horizon):
    """The (roll_idx, start) of every epoch of JAX's train_model."""
    out = []
    for ekey in jax.random.split(key, num_epochs):
        sample_key, _ = jax.random.split(ekey)
        ri, st = JR.epoch_batches(jbuf, sample_key, batch_size, horizon)
        out.append((torch.as_tensor(np.asarray(ri)),
                    torch.as_tensor(np.asarray(st))))
    return out


@pytest.mark.parametrize('kind,horizon', [('lin', 1), ('rw', 1),
                                          ('rnn', 3)])
def test_fit_matches_jax_train_model(buffers, kind, horizon):
    jbuf, tbuf = buffers
    jm, jp, tm, tp = _pair(kind, seed=7)
    key, epochs, bs = jax.random.PRNGKey(11), 2, 4
    jp2, _, jlog = JT.train_model(
        jm, jp, jbuf, key, optimizer=optax.adam(0.01), batch_size=bs,
        num_epochs=epochs, horizon=horizon,
        normalizers=JT.make_normalizers(jbuf))
    leaves = T.param_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = T.adam(0.01)(leaves)
    tn = T.make_normalizers(tbuf)
    losses = torch.cat([
        T.fit_epoch(tm, tp, tbuf, opt, ri, st, horizon=horizon,
                    normalizers=tn)
        for ri, st in _jax_epoch_indices(jbuf, key, epochs, bs, horizon)])
    assert losses.shape == jlog.losses.shape
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlog.losses),
                               rtol=1e-4)
    for layer in tp:
        for k in ('w', 'b'):
            np.testing.assert_allclose(
                tp[layer][k].detach().numpy(), np.asarray(jp2[layer][k]),
                rtol=1e-4, atol=1e-5, err_msg=f'{layer}.{k}')


def test_train_model_and_evaluate_take_each_family(buffers):
    """The port's own train_model / evaluate_model loop over every new
    family (its draws are its own): finite losses, one per minibatch."""
    _, tbuf = buffers
    for kind, horizon in (('lin', 1), ('rw', 2), ('rnn', 3)):
        _, _, tm, tp = _pair(kind)
        g = torch.Generator().manual_seed(0)
        _, _, log = T.train_model(tm, tp, tbuf, g, batch_size=4,
                                  num_epochs=2, horizon=horizon,
                                  normalizers=T.make_normalizers(tbuf))
        per_epoch = CAP * (LEN - horizon + 1) // 4
        assert log.losses.shape == (2 * per_epoch,), kind
        assert bool(torch.isfinite(log.losses).all())
        ev = T.evaluate_model(tm, tp, tbuf, g, batch_size=4,
                              horizon=horizon)
        assert ev.ndim == 0 and bool(torch.isfinite(ev))


def test_mlp_noise_only_with_a_random_source(buffers):
    """JAX adds N(0, noise^2) to the normalized output only with a key;
    the port only with a generator. Without one both are the plain MLP;
    with one the added noise, taken back to normalized space, has mean 0
    and std ``noise`` (4 sigma over 20,000 draws)."""
    jbuf, tbuf = buffers
    jm = jmodels.MLPDynamics(SD, AD, hidden_units=8, noise=0.3)
    tm = models.MLPDynamics(SD, AD, hidden_units=8, noise=0.3)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.mlp_params(_np(jp))
    jn, tn = JT.make_normalizers(jbuf), T.make_normalizers(tbuf)
    s, a = _inputs(8, (4000,))
    plain = tm.forward(tp, torch.as_tensor(s), torch.as_tensor(a), tn)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jm.forward(jp, s, a, jn)), rtol=RTOL,
        atol=1e-5)
    noisy = tm.forward(tp, torch.as_tensor(s), torch.as_tensor(a), tn,
                       generator=torch.Generator().manual_seed(1))
    jnoisy = jm.forward(jp, s, a, jn, key=jax.random.PRNGKey(1))
    for out, base in ((noisy.numpy(), plain.numpy()),
                      (np.asarray(jnoisy), plain.numpy())):
        z = ((out - base) / (tn.state_std.numpy() + 1e-6)).ravel()
        assert abs(z.mean()) < 4 * 0.3 / np.sqrt(z.size)
        assert abs(z.std() - 0.3) < 4 * 0.3 / np.sqrt(2 * z.size)


def test_rnn_through_an_agents_call_fails_on_both_sides(buffers):
    jbuf, tbuf = buffers
    jm, jp, tm, tp = _pair('rnn')
    s, a = _inputs(9)
    with pytest.raises(TypeError, match='concatenate'):
        jm.forward(jp, jnp.asarray(s), jnp.asarray(a),
                   JT.make_normalizers(jbuf))
    with pytest.raises(TypeError, match='hidden state'):
        tm.forward(tp, torch.as_tensor(s), torch.as_tensor(a),
                   T.make_normalizers(tbuf))


def test_new_families_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    g = torch.Generator().manual_seed(0)
    for model in (models.LinearDynamics(SD, AD), models.RewardDynamics(SD, AD),
                  models.RNNDynamics(SD, AD), models.CostModel(SD, AD)):
        with pytest.raises(RuntimeError, match='CUDA'):
            model.init(g)
    with pytest.raises(RuntimeError, match='CUDA'):
        models.RNNDynamics(SD, AD).init_hidden((2,))


def test_costs_match_jax():
    """quadratic_cost, state_action_cost, the goal-conditioned classes and
    the learned CostModel on the same inputs (rtol 1e-5)."""
    s, a = _inputs(10)
    rng = np.random.RandomState(11)
    goal = rng.normal(size=SD).astype(np.float32)
    Q = rng.uniform(size=(SD, SD)).astype(np.float32) / SD
    w = rng.uniform(0.5, 2, SD).astype(np.float32)
    t = torch.as_tensor
    np.testing.assert_allclose(
        models.quadratic_cost(t(s), t(goal), t(Q)).numpy(),
        np.asarray(jmodels.quadratic_cost(s, goal, Q)), rtol=1e-5)
    jq, tq = jmodels.QuadraticCost(SD), models.QuadraticCost(SD)
    assert tq.Q.shape == (SD, SD) and 0 <= float(tq.Q.min()) and float(
        tq.Q.max()) < 1 / SD
    jq.Q, tq.Q = Q, t(Q)
    jsa, tsa = jmodels.SmoothAbsLoss(w), models.SmoothAbsLoss(t(w))
    for j, c in ((jq, tq), (jsa, tsa)):
        j.set_goal_state(goal)
        c.set_goal_state(t(goal))
        np.testing.assert_allclose(
            models.state_action_cost(t(s), t(a), c, models.CoshLoss()).numpy(),
            np.asarray(jmodels.state_action_cost(s, a, j, jmodels.CoshLoss())),
            rtol=1e-5)
    jc = jmodels.CostModel(SD, AD, hidden_units=10)
    jp = jc.init(jax.random.PRNGKey(3))
    tc = models.CostModel(SD, AD, hidden_units=10)
    tp = convert.mlp_params(_np(jp))
    assert {k: v['w'].shape for k, v in tc.init(
        torch.Generator(), device='cpu').items()} == {
            k: v['w'].shape for k, v in tp.items()}
    np.testing.assert_allclose(tc.forward(tp, t(s), t(a)).numpy(),
                               np.asarray(jc.forward(jp, s, a)), rtol=1e-5,
                               atol=1e-6)
