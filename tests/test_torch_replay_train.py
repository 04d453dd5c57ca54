"""Replay buffer and model fitting, port vs JAX.

* ``add_rollouts`` across a ring wrap, the stored fields exactly and the
  masked stats (n - 1 variance) at rtol 1e-5.
* ``epoch_batches``: shapes, every filled (rollout, start) once, and the
  remap of unfilled rows into the filled range.
* ``gather_windows`` on the JAX package's indices: exact.
* ``train_model`` fed the JAX package's own epoch indices (reproduced from
  the key splits of ``models/train.py:89-115``): per-minibatch losses and
  final params at rtol 1e-4 for the MLP (Adam and SGD). JAX always
  bootstraps the ensemble in ``train_model``, so for the ensemble the loss
  without a key and its gradients are held against ``jax.grad`` (rtol
  1e-4), and the bootstrap is checked to drive identical members apart.
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

CAP, LEN, SD, OD, AD = 6, 10, 8, 10, 3


def _rollouts(rng, B):
    scale = lambda d: rng.uniform(0.5, 3.0, d).astype(np.float32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return JR.Rollouts(states=f(B, LEN + 1, SD) * scale(SD),
                       observations=f(B, LEN + 1, OD) * scale(OD) + 1.0,
                       actions=np.clip(f(B, LEN, AD), -1, 1),
                       rewards=f(B, LEN))


@pytest.fixture(scope='module')
def buffers():
    """JAX and port buffers after adds of 3, 3 and 2 rollouts into a ring
    of 6 (the last add wraps). Also the state after the first add."""
    rng = np.random.RandomState(0)
    jbuf = JR.init_replay(CAP, LEN, SD, OD, AD)
    tbuf = R.init_replay(CAP, LEN, SD, OD, AD, device='cpu')
    partial = None
    for B in (3, 3, 2):
        rolls = _rollouts(rng, B)
        jbuf = JR.add_rollouts(jbuf, jax.tree_util.tree_map(jnp.asarray,
                                                            rolls))
        tbuf = R.add_rollouts(tbuf, convert.rollouts(rolls))
        if partial is None:
            partial = (jbuf, R.from_tree({
                k: v.clone() if torch.is_tensor(v) else v
                for k, v in R.as_tree(tbuf).items()}))
    return jbuf, tbuf, partial


def test_add_rollouts_and_stats_match_jax(buffers):
    jbuf, tbuf, (jpart, tpart) = buffers
    for jb, tb in ((jbuf, tbuf), (jpart, tpart)):
        assert (tb.cursor, tb.filled) == (int(jb.cursor), int(jb.filled))
        for f in ('states', 'observations', 'actions', 'rewards'):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
        for f, st in tb.stats.items():
            for k in ('mean', 'std', 'min', 'max'):
                np.testing.assert_allclose(
                    getattr(st, k).numpy(),
                    np.asarray(getattr(jb.stats[f], k)), rtol=1e-5,
                    atol=1e-6, err_msg=f'{f}.{k}')
    assert (tbuf.cursor, tbuf.filled) == (2, CAP)


def test_empty_buffer_stats_and_oversized_add():
    buf = R.init_replay(3, 2, 1, 1, 1, device='cpu')
    st = buf.stats['states']
    assert float(st.mean) == 0 and float(st.std) == 0
    assert float(st.min) == float('inf') and float(st.max) == -float('inf')
    # 5 rollouts (rollout i filled with i) into a ring of 3: the last 3
    # are kept, in ring order, and the cursor ends at 5 % 3
    i = torch.arange(5.)
    rolls = R.Rollouts(states=i.view(5, 1, 1).expand(5, 3, 1),
                       observations=i.view(5, 1, 1).expand(5, 3, 1),
                       actions=i.view(5, 1, 1).expand(5, 2, 1),
                       rewards=i.view(5, 1).expand(5, 2))
    buf = R.add_rollouts(buf, rolls)
    assert (buf.cursor, buf.filled) == (2, 3)
    assert sorted(buf.states[:, 0, 0].tolist()) == [2.0, 3.0, 4.0]
    assert buf.states[2, 0, 0] == 2.0 and buf.states[0, 0, 0] == 3.0


def test_epoch_batches_cover_the_filled_rows(buffers):
    _, _, (_, tpart) = buffers                 # 3 of 6 rollouts filled
    ri, st = R.epoch_batches(tpart, torch.Generator().manual_seed(0), 7)
    per_roll = LEN
    assert ri.shape == st.shape == (CAP * per_roll // 7, 7)
    assert int(ri.max()) < tpart.filled and int(ri.min()) >= 0
    assert int(st.max()) < per_roll and int(st.min()) >= 0
    full_ri, full_st = R.epoch_batches(tpart, torch.Generator().manual_seed(
        0), CAP * per_roll)
    pairs = (full_ri[0] * per_roll + full_st[0]).tolist()
    # every filled (rollout, start) appears: once from the permutation,
    # plus wherever an unfilled row was remapped onto it
    assert set(pairs) == set(range(tpart.filled * per_roll))
    # the remap keeps each start's count: every start appears once per
    # rollout of the ring
    assert torch.bincount(full_st[0], minlength=per_roll).tolist() == \
        [CAP] * per_roll


def test_gather_windows_on_jax_indices(buffers):
    jbuf, tbuf, _ = buffers
    for horizon in (1, 3):
        ri, st = JR.epoch_batches(jbuf, jax.random.PRNGKey(horizon), 8,
                                  horizon)
        ri, st = np.array(ri)[0], np.array(st)[0]
        ref = jax.jit(JR.gather_windows, static_argnums=3)(
            jbuf, jnp.asarray(ri), jnp.asarray(st), horizon)
        got = R.gather_windows(tbuf, torch.as_tensor(ri),
                               torch.as_tensor(st), horizon)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


def test_make_normalizers_match_jax(buffers):
    jbuf, tbuf, _ = buffers
    for obs in (True, False):
        ref = JT.make_normalizers(jbuf, use_observations=obs)
        got = T.make_normalizers(tbuf, use_observations=obs)
        for k in ('state_mean', 'state_std', 'action_mean', 'action_std',
                  'reward_mean', 'reward_std'):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       rtol=1e-5, atol=1e-6)


def _jax_epoch_indices(jbuf, key, num_epochs, batch_size):
    """The (roll_idx, start) of every epoch of JAX's train_model."""
    out = []
    for ekey in jax.random.split(key, num_epochs):
        sample_key, _ = jax.random.split(ekey)
        ri, st = JR.epoch_batches(jbuf, sample_key, batch_size, 1)
        out.append((torch.as_tensor(np.asarray(ri)),
                    torch.as_tensor(np.asarray(st))))
    return out


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_train_model_matches_jax_on_its_indices(buffers, opt):
    jbuf, tbuf, _ = buffers
    model = jmodels.MLPDynamics(OD, AD, hidden_units=16)
    jparams = model.init(jax.random.PRNGKey(5))
    key, epochs, bs = jax.random.PRNGKey(9), 2, 16
    jopt = optax.adam(0.01) if opt == 'adam' else optax.sgd(0.1)
    jnorm = JT.make_normalizers(jbuf)
    jp, _, jlog = JT.train_model(model, jparams, jbuf, key, optimizer=jopt,
                                 batch_size=bs, num_epochs=epochs,
                                 normalizers=jnorm)

    tmodel = models.MLPDynamics(OD, AD, hidden_units=16)
    tp = convert.mlp_params(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = T.param_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    topt = (T.adam(0.01) if opt == 'adam' else T.sgd(0.1))(leaves)
    tnorm = T.make_normalizers(tbuf)
    losses = torch.cat([
        T.fit_epoch(tmodel, tp, tbuf, topt, ri, st, normalizers=tnorm)
        for ri, st in _jax_epoch_indices(jbuf, key, epochs, bs)])
    assert losses.shape == jlog.losses.shape == (epochs * (CAP * LEN // bs),)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlog.losses),
                               rtol=1e-4)
    for layer in ('l1', 'l2', 'l3'):
        for k in ('w', 'b'):
            np.testing.assert_allclose(
                tp[layer][k].detach().numpy(), np.asarray(jp[layer][k]),
                rtol=1e-4, atol=1e-5, err_msg=f'{layer}.{k}')


def test_ensemble_loss_and_gradients_match_jax(buffers):
    jbuf, tbuf, _ = buffers
    ens = jmodels.EnsembleDynamics(jmodels.MLPDynamics(OD, AD, 16), 3)
    jparams = ens.init(jax.random.PRNGKey(6))
    ri, st = JR.epoch_batches(jbuf, jax.random.PRNGKey(7), 16, 1)
    win = JR.gather_windows(jbuf, ri[0], st[0], 1)
    jbatch = JT._batch_from_windows(win, True)
    jnorm = JT.make_normalizers(jbuf)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: ens.loss(p, jbatch, jnorm)))(jparams)

    tens = models.EnsembleDynamics(models.MLPDynamics(OD, AD, 16), 3)
    tp = convert.ensemble_params(jax.tree_util.tree_map(np.asarray,
                                                        jparams))
    for leaf in T.param_leaves(tp):
        leaf.requires_grad_(True)
    tbatch = T._batch_from_windows(R.gather_windows(
        tbuf, torch.as_tensor(np.asarray(ri[0])),
        torch.as_tensor(np.asarray(st[0])), 1), True)
    tloss = tens.loss(tp, tbatch, T.make_normalizers(tbuf))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4)
    for layer in ('l1', 'l2', 'l3'):
        for k in ('w', 'b'):
            np.testing.assert_allclose(
                tp[layer][k].grad.numpy(), np.asarray(jgrad[layer][k]),
                rtol=1e-4, atol=1e-6, err_msg=f'{layer}.{k}')


def test_bootstrap_drives_identical_members_apart(buffers):
    _, tbuf, _ = buffers
    tens = models.EnsembleDynamics(models.MLPDynamics(OD, AD, 16), 4)
    one = models.MLPDynamics(OD, AD, 16).init(torch.Generator().manual_seed(
        0), device='cpu')
    params = {l: {k: v[None].repeat((4,) + (1,) * v.ndim).contiguous()
                  for k, v in p.items()} for l, p in one.items()}
    params, _, log = T.train_model(
        tens, params, tbuf, torch.Generator().manual_seed(1), batch_size=16,
        num_epochs=4, normalizers=T.make_normalizers(tbuf))
    assert log.losses.shape == (4 * (CAP * LEN // 16),)
    assert float(log.losses[-3:].mean()) < float(log.losses[:3].mean())
    w = params['l1']['w'].detach().reshape(4, -1)
    dists = [float((w[i] - w[j]).abs().max()) for i in range(4)
             for j in range(i + 1, 4)]
    assert min(dists) > 1e-6, 'bootstrap left members identical'
    ev = T.evaluate_model(tens, params, tbuf,
                          torch.Generator().manual_seed(2), batch_size=8,
                          normalizers=T.make_normalizers(tbuf))
    assert bool(torch.isfinite(ev))
