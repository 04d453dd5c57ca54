"""Staging layout of the tensor-core sampler kernels (ops/cem_mma.py).

The CUDA kernels (csrc/cem_sample_rollout.cu, csrc/cem_sample_rollout_ens.cu)
read the weights as ``cem_mma.pack_weights`` lays them out: zero-padded to
multiples of 8, rows permuted within every 8-block, in mma.sync fragment
order, split into TF32 hi / lo when a block stages them. Here a torch
emulation reads that buffer back lane by lane, splits it the same way,
forms the 3xTF32 products (hi*hi + hi*lo + lo*hi, exact
products summed in float64 and rounded to float32 per accumulator, as the
kernel keeps the hi*hi and correction sums apart; the kernel's rounding of
each tensor-core step is not modelled) on activations permuted
as the kernel's registers hold them, and is held to:

1. the plain float32 product of one layer (about 1e-6 relative);
2. ``mlp_rollout_costs_reference`` over a 30-step walker rollout (rtol =
   atol = 1e-4, the tolerance chip_smoke holds the kernel to), with seeded
   random weights and with a JAX-initialised MLP carried over by
   ``convert`` (and the JAX reference), without and with replay-like
   normalizers folded in;
3. a single TF32 pass (hi*hi only): its error against float64 is
   asserted to be several times the split's (the split is about as close
   as float32 itself); uncentred, with replay statistics folding large
   rows into W1 (as on a fitted model), it breaks the tolerance, which the
   centring of the state (``cem_mma.fold_centred``) repairs.

The row map (``tile_rows``) is checked to cover every candidate once, with
antithetic pairs sharing a thread where the kernels share their draw.
"""

import jax
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.models import MLPDynamics as JMLP
from mujoco_mbrl_tpu.models import Normalizers as JNorm
from mujoco_mbrl_tpu.ops import cem_rollout as jcem
from mujoco_mbrl_tpu_torch import convert
from mujoco_mbrl_tpu_torch.models import (EnsembleDynamics, MLPDynamics,
                                          Normalizers)
from mujoco_mbrl_tpu_torch.ops import cem_mma, cem_rollout

SD, AD, HID, H, N = 24, 6, 50, 30, 64


def _unpack(packed, lay, layer):
    """B matrices (hi, lo) of one layer in fragment row order, read back
    from the packed buffer lane by lane and split as the kernel stages
    them: row 8k + t holds b0 of lane 4 g + t, row 8k + t + 4 its b1,
    column 8n + g."""
    kt, nt, off = {1: (lay.ni, lay.nh, lay.l1), 2: (lay.nh, lay.nh, lay.l2),
                   3: (lay.nh, lay.nso, lay.l3)}[layer]
    raw = packed[off:off + 128 * kt * nt].reshape(kt, nt, 32, 4)
    assert torch.equal(raw[..., 2:], raw[..., :2])   # (b0, b1, b0, b1)
    hi_lo = cem_mma.split(raw[..., :2])
    frag = torch.cat(hi_lo, dim=-1)
    hi = torch.zeros(8 * kt, 8 * nt)
    lo = torch.zeros(8 * kt, 8 * nt)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for k in range(kt):
            for n in range(nt):
                v, col = frag[k, n, lane], 8 * n + g
                hi[8 * k + t, col], hi[8 * k + t + 4, col] = v[0], v[1]
                lo[8 * k + t, col], lo[8 * k + t + 4, col] = v[2], v[3]
    return hi, lo


def _a_order(x):
    """Activations (M, 8 kt) as the A fragments hold them: position 8k + p
    is column 8k + ROW_PERM[p] (a thread's accumulator columns 2t, 2t+1
    sit at A positions t, t + 4)."""
    perm = torch.tensor(cem_mma.ROW_PERM)
    cols = (8 * torch.arange(x.shape[1] // 8)[:, None] + perm).reshape(-1)
    return x[:, cols]


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def _product(x, hi, lo, bias, three=True):
    """The kernel's accumulators: big = bias + A_hi B_hi, small = A_hi B_lo
    + A_lo B_hi (products exact, sums in float64, each rounded to float32),
    out = big + small. three=False: a single TF32 pass."""
    a_hi, a_lo = cem_mma.split(_a_order(x))
    d = lambda a, b: (a.double() @ b.double())
    big = (bias.double() + d(a_hi, hi)).float()
    if not three:
        return big
    return big + (d(a_hi, lo) + d(a_lo, hi)).float()


class Emulated:
    """The kernel's model step on the packed buffer of one member."""

    def __init__(self, packed, sd, ad, hid, three=True):
        self.lay = lay = cem_mma.layout(sd, ad, hid)
        self.sd, self.ad, self.three = sd, ad, three
        self.w = {l: _unpack(packed, lay, l) for l in (1, 2, 3)}
        seg = lambda o, n: packed[o:o + n]
        self.b1 = seg(lay.b1, 8 * lay.nh)
        self.b2 = seg(lay.b2, 8 * lay.nh)
        self.b3 = seg(lay.b3, 8 * lay.nso)
        self.goal = seg(lay.goal, sd)
        self.wvec = seg(lay.wvec, sd)

    def step(self, s, a):
        lay = self.lay
        x = _pad(torch.cat([s, a], -1), 8 * lay.ni)
        h = torch.relu(_product(x, *self.w[1], self.b1, self.three))
        h = torch.relu(_product(h, *self.w[2], self.b2, self.three))
        return _product(h, *self.w[3], self.b3, self.three)[:, :self.sd]

    def costs(self, s0, actions, alpha_s=0.4, alpha_a=0.25):
        """s0 (N, sd), actions (H, N, ad) -> costs (N,)."""
        s, acc = s0, torch.zeros(s0.shape[0])
        for a in actions:
            s = self.step(s, a)
            d = (s - self.goal) * self.wvec
            acc = acc + (torch.sum(torch.sqrt(d * d + alpha_s ** 2) - alpha_s,
                                   -1)
                         + alpha_a ** 2 * torch.mean(
                             torch.cosh(a / alpha_a) - 1.0, -1))
        return acc


def _params(kind, seed):
    if kind == 'seeded':
        return MLPDynamics(SD, AD, hidden_units=HID).init(
            torch.Generator().manual_seed(seed), device='cpu')
    return convert.mlp_params(jax.tree_util.tree_map(
        np.asarray, JMLP(SD, AD, HID).init(jax.random.PRNGKey(seed))))


def _packed(params, goal, wvec):
    w = cem_rollout._fold_normalizers(params, None)
    return cem_mma.pack_weights(*w, goal, wvec)[0]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    s0 = torch.as_tensor(rng.normal(size=(N, SD)).astype(np.float32))
    acts = torch.as_tensor(rng.uniform(-1, 1, size=(H, N, AD)).astype(
        np.float32))
    goal = torch.as_tensor(rng.normal(size=SD).astype(np.float32))
    wvec = torch.as_tensor(rng.uniform(size=SD).astype(np.float32))
    return s0, acts, goal, wvec


def test_packing_pads_permutes_and_splits():
    params = _params('seeded', 0)
    s0, acts, goal, wvec = _inputs(0)
    lay = cem_mma.layout(SD, AD, HID)
    # 32 x 56, 56 x 56, 56 x 24
    assert (lay.ni, lay.nh, lay.nso) == (4, 7, 3)
    packed = _packed(params, goal, wvec)
    assert packed.shape == (lay.total,) and lay.total % 4 == 0
    perm = torch.tensor(cem_mma.ROW_PERM)
    for layer, w in ((1, params['l1']['w']), (2, params['l2']['w']),
                     (3, params['l3']['w'])):
        hi, lo = _unpack(packed, lay, layer)
        assert torch.equal(cem_mma.tf32(hi), hi)
        assert torch.equal(cem_mma.tf32(lo), lo)
        full = torch.zeros(hi.shape)
        full[:w.shape[0], :w.shape[1]] = w
        rows = (8 * torch.arange(hi.shape[0] // 8)[:, None] + perm).reshape(-1)
        want = full[rows]
        torch.testing.assert_close(hi + lo, want, rtol=3e-7, atol=0)
        assert float(hi.abs().max()) > 0
        # the padding is zero: W rows >= in, columns >= out
        assert not bool(((hi != 0) & (want == 0)).any())
    torch.testing.assert_close(packed[lay.goal:lay.goal + SD], goal)
    assert float(packed[lay.wvec + SD:lay.wvec + 8 * lay.ni].abs().sum()) == 0


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                      1 + 2 ** -12, 1 + 2 ** -10 + 2 ** -11])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10),
                         1.0, 1 + 2 ** -9])
    assert torch.equal(cem_mma.tf32(x), want)


@pytest.mark.parametrize('layer', [1, 2, 3])
def test_emulated_3xtf32_product_matches_float32(layer):
    params = _params('seeded', 1)
    s0, acts, goal, wvec = _inputs(1)
    emu = Emulated(_packed(params, goal, wvec), SD, AD, HID)
    lay = emu.lay
    g = torch.Generator().manual_seed(layer)
    w, b = params[f'l{layer}']['w'], params[f'l{layer}']['b']
    x = torch.randn((N, w.shape[0]), generator=g)
    kt = {1: lay.ni, 2: lay.nh, 3: lay.nh}[layer]
    width = {1: 8 * lay.nh, 2: 8 * lay.nh, 3: 8 * lay.nso}[layer]
    bias = _pad(b[None], width)[0]
    got = _product(_pad(x, 8 * kt), *emu.w[layer], bias)[:, :w.shape[1]]
    plain = x @ w + b
    exact = (x.double() @ w.double() + b.double())
    scale = float((x.abs().double() @ w.abs().double()).max())
    err, err_plain = (float((v.double() - exact).abs().max()) / scale
                      for v in (got, plain))
    assert err < 1e-6, (err, err_plain)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6 * scale)
    # one TF32 pass is ~3 decimal digits
    one = _product(_pad(x, 8 * kt), *emu.w[layer], bias, three=False)
    err_one = float((one[:, :w.shape[1]].double() - exact).abs().max()) / scale
    assert err_one > 100 * max(err, 1e-9), (err_one, err)


def _normalizers(seed):
    """Replay-like stats: one near-constant state dim gives large folded
    W1 rows (|W1'| ~ 180), as a fitted replay does."""
    rng = np.random.RandomState(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    s_std = 0.1 + rng.uniform(size=SD)
    s_std[3] = 1e-3
    return Normalizers(state_mean=f(rng.normal(size=SD)), state_std=f(s_std),
                       action_mean=f(0.1 * rng.normal(size=AD)),
                       action_std=f(0.5 + rng.uniform(size=AD)))


def _f64_costs(w, s0, acts, goal, wvec):
    """Float64 costs with the float32 folded weights ``w``."""
    tree = {l: {'w': w[2 * i].double(), 'b': w[2 * i + 1].double()}
            for i, l in enumerate(('l1', 'l2', 'l3'))}
    return cem_rollout.mlp_rollout_costs_reference(
        tree, s0.double(), acts.double(), goal.double(), wvec.double())


def _emulated(params, norm, s0, acts, goal, wvec, three=True, centred=True):
    """Costs through the emulated kernel, folded and packed as the wrapper
    does it (centred: x = s - mu, ``cem_mma.fold_centred``), or with the
    plain version's fold (``centred=False``)."""
    if centred:
        *w, x0, goal = cem_mma.fold_centred(params, norm, s0, goal)
    else:
        w, x0 = cem_rollout._fold_normalizers(params, norm), s0
    packed = cem_mma.pack_weights(*w, goal, wvec)[0]
    return Emulated(packed, SD, AD, HID, three).costs(x0, acts)


@pytest.mark.parametrize('normalized', [False, True])
@pytest.mark.parametrize('kind', ['seeded', 'jax'])
def test_emulated_rollout_costs_hold_the_kernel_tolerance(kind, normalized):
    params = _params(kind, 2)
    s0, acts, goal, wvec = _inputs(2)
    norm = _normalizers(3) if normalized else None
    if norm is not None:
        s0 = norm.state_mean + norm.state_std * s0
    ref = cem_rollout.mlp_rollout_costs_reference(params, s0, acts, goal,
                                                  wvec, norm)
    w = cem_rollout._fold_normalizers(params, norm)
    got = _emulated(params, norm, s0, acts, goal, wvec)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    if kind == 'jax':
        jparams = jax.tree_util.tree_map(np.asarray, JMLP(SD, AD, HID).init(
            jax.random.PRNGKey(2)))
        jnorm = None if norm is None else JNorm(
            **{k: getattr(norm, k).numpy() for k in
               ('state_mean', 'state_std', 'action_mean', 'action_std')})
        jref = np.asarray(jcem.mlp_rollout_costs_reference(
            jparams, s0.numpy(), acts.numpy(), goal.numpy(), wvec.numpy(),
            jnorm))
        np.testing.assert_allclose(got.numpy(), jref, rtol=1e-4, atol=1e-4)
    # against float64: the split is about as close as float32 itself; a
    # single TF32 pass is several times further off
    r64 = _f64_costs(w, s0, acts, goal, wvec)
    rel = lambda c: float(((c.double() - r64).abs() / (r64.abs() + 1e-4)).max())
    one = _emulated(params, norm, s0, acts, goal, wvec, three=False)
    assert rel(got) < 2 * rel(ref) + 1e-7, (rel(got), rel(ref))
    assert rel(one) > 3 * rel(got), (rel(one), rel(got))


@pytest.mark.parametrize('n', [None, 3])
def test_centred_fold_is_the_plain_fold_shifted(n):
    # MLP_plain(s) = MLP_centred(s - mu) + mu, in float64
    mlp = MLPDynamics(SD, AD, hidden_units=HID)
    model = mlp if n is None else EnsembleDynamics(mlp, n)
    init = model.init(torch.Generator().manual_seed(4), device='cpu')
    params = {l: {k: v.double() for k, v in d.items()}
              for l, d in init.items()}
    n5 = _normalizers(5)
    norm = Normalizers(**{k: getattr(n5, k).double() for k in (
        'state_mean', 'state_std', 'action_mean', 'action_std')})
    g = torch.Generator().manual_seed(6)
    s = norm.state_mean + norm.state_std * torch.randn(
        (7, SD), generator=g, dtype=torch.float64)
    a = torch.rand((7, AD), generator=g, dtype=torch.float64)
    goal = torch.randn(SD, generator=g, dtype=torch.float64)
    u = lambda b: b.unsqueeze(-2)    # a bias, broadcast over the rows
    step = lambda w, x: torch.relu(torch.relu(
        torch.cat([x, a], -1) @ w[0] + u(w[1])) @ w[2] + u(w[3])) @ w[4] \
        + u(w[5])
    *wc, x0, goal_c = cem_mma.fold_centred(params, norm, s, goal)
    wp = cem_rollout._fold_normalizers(params, norm)
    torch.testing.assert_close(x0, s - norm.state_mean)
    torch.testing.assert_close(goal_c, goal - norm.state_mean)
    torch.testing.assert_close(step(wc, x0) + norm.state_mean, step(wp, s),
                               rtol=1e-10, atol=1e-10)


def test_centring_removes_the_cancellation_of_folded_normalizers():
    # replay statistics with a near-constant state dimension fold a row of
    # ~1 / 1e-3 into W1, cancelled by b1: uncentred, one TF32 pass breaks
    # the kernel tolerance (the split still holds it); centred at the state
    # mean, the product is O(1) and even one pass is ~100x closer
    params = _params('seeded', 2)
    s0, acts, goal, wvec = _inputs(2)
    norm = _normalizers(3)
    s0 = norm.state_mean + norm.state_std * s0
    w = cem_rollout._fold_normalizers(params, norm)
    assert float(w[0].abs().max()) > 100
    r64 = _f64_costs(w, s0, acts, goal, wvec)
    rel = lambda c: float(((c.double() - r64).abs() / (r64.abs() + 1e-4)).max())
    raw_one = _emulated(params, norm, s0, acts, goal, wvec, False,
                        centred=False)
    raw = _emulated(params, norm, s0, acts, goal, wvec, centred=False)
    one = _emulated(params, norm, s0, acts, goal, wvec, False)
    assert rel(raw_one) > 1e-4, rel(raw_one)
    assert rel(raw) < 1e-5, rel(raw)
    assert rel(raw_one) > 20 * rel(one), (rel(raw_one), rel(one))


@pytest.mark.parametrize('K,n,antithetic', [
    (1000, 1, True), (101, 1, True), (101, 1, False), (1000, 5, True),
    (60, 4, True), (60, 4, False), (200, 5, True)])
def test_tile_rows_cover_every_candidate_once(K, n, antithetic):
    T = cem_mma.tiles_per_env(K, n, antithetic)
    shared = cem_mma.shared_pairs(K, n, antithetic)
    Kz = (K + 1) // 2 if antithetic else K
    seen = []
    for m in range(n):
        for i in range(T):
            rows = cem_mma.tile_rows(K, n, antithetic, m, i)
            for r, row in enumerate(rows):
                if not row.valid:
                    continue
                assert row.k % n == m and 0 <= row.k < K
                second = antithetic and row.k >= Kz
                assert row.pair == (row.k - Kz if second else row.k)
                assert row.sign == (-1.0 if second else 1.0)
                seen.append(row.k)
            if shared:  # rows g and g + 8: one pair, one draw
                for g in range(8):
                    assert rows[g].pair == rows[g + 8].pair
                    assert rows[g + 8].k == rows[g].k + Kz
    assert sorted(seen) == list(range(K))
    # walker (K 1000, antithetic) fills 63 tiles of 8 pairs per env
    if (K, n, antithetic) == (1000, 1, True):
        assert T == 63 and shared
    if (K, n) == (60, 4):
        assert not shared


# ---- the given-action kernel (csrc/cem_rollout_costs.cu) on the same body:
# tiles of 16 consecutive candidates, each row from its own start state,
# centred at the state mean as the kernel loads it

@pytest.mark.parametrize('N', [1000, 37, 16])
def test_given_rows_cover_every_candidate_once(N):
    seen = []
    for i in range(cem_mma.given_tiles(N)):
        rows = cem_mma.given_rows(N, i)
        assert [r.k for r in rows] == list(range(16 * i, 16 * i + 16))
        seen += [r.k for r in rows if r.valid]
        assert all(r.valid == (r.k < N) for r in rows)
    assert seen == list(range(N))
    assert cem_mma.given_tiles(N) == -(-N // 16)


def _kernel_start_states(s0T, mu):
    """The start states as the kernel's threads load them: tile i, row g
    (and g + 8) of lane 4 g + t, columns 8 k + 2 t + e < sd, each
    s0T[col, n] - mu[col]; rows past N stay zero."""
    sd, N = s0T.shape
    x = torch.zeros((cem_mma.given_tiles(N) * 16, sd))
    for i in range(cem_mma.given_tiles(N)):
        rows = cem_mma.given_rows(N, i)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for k in range(-(-sd // 8)):
                for e in range(2):
                    col = 8 * k + 2 * t + e
                    for row in (rows[g], rows[g + 8]):
                        if col < sd and row.valid:
                            x[row.k, col] = s0T[col, row.k] - mu[col]
    return x[:N]


def _given_problem(sd, normalized, seed, N=200, horizon=5):
    rng = np.random.RandomState(seed)
    jparams = jax.tree_util.tree_map(np.asarray, JMLP(sd, AD, HID).init(
        jax.random.PRNGKey(seed)))
    jnorm = None
    if normalized:
        s_std = 0.1 + rng.uniform(size=sd)
        s_std[3] = 1e-3            # a near-constant dim, as in a replay
        jnorm = JNorm(**{k: np.asarray(v, np.float32) for k, v in dict(
            state_mean=rng.normal(size=sd), state_std=s_std,
            action_mean=0.1 * rng.normal(size=AD),
            action_std=0.5 + rng.uniform(size=AD)).items()})
    s0 = rng.normal(size=(N, sd)).astype(np.float32)
    if jnorm is not None:
        s0 = jnorm.state_mean + jnorm.state_std * s0
    acts = rng.uniform(-1, 1, size=(horizon, N, AD)).astype(np.float32)
    goal = rng.normal(size=sd).astype(np.float32)
    wvec = rng.uniform(size=sd).astype(np.float32)
    norm = None if jnorm is None else Normalizers(**{
        k: torch.as_tensor(getattr(jnorm, k)) for k in (
            'state_mean', 'state_std', 'action_mean', 'action_std')})
    return jparams, jnorm, norm, s0, acts, goal, wvec


@pytest.mark.parametrize('normalized', [False, True])
def test_given_kernel_centring_is_fold_centred(normalized):
    # the wrapper's packed buffer is the samplers' (fold_centred, packed),
    # and the kernel's load, s0T[:, n] - mu, is fold_centred's x0
    jparams, _, norm, s0, _, goal, wvec = _given_problem(17, normalized, 7,
                                                         N=37)
    params = convert.mlp_params(jparams)
    s0, goal, wvec = (torch.as_tensor(a) for a in (s0, goal, wvec))
    packed, mu = cem_rollout.given_inputs(params, norm, goal, wvec)
    *w, x0, goal_c = cem_mma.fold_centred(params, norm, s0, goal)
    assert torch.equal(packed, cem_mma.pack_weights(*w, goal_c, wvec))
    assert mu.shape == (17,)
    if norm is None:
        assert float(mu.abs().max()) == 0.0
    else:
        assert torch.equal(mu, norm.state_mean)
    assert torch.equal(_kernel_start_states(s0.T.contiguous(), mu), x0)
    lay = cem_mma.layout(17, AD, HID)
    assert torch.equal(packed[0, lay.goal:lay.goal + 17], goal_c)


@pytest.mark.parametrize('normalized', [False, True])
@pytest.mark.parametrize('sd', [24, 17])
def test_emulated_given_action_costs_match_jax_reference(sd, normalized):
    jparams, jnorm, norm, s0, acts, goal, wvec = _given_problem(
        sd, normalized, 8 + sd)
    params = convert.mlp_params(jparams)
    t = torch.as_tensor
    packed, mu = cem_rollout.given_inputs(params, norm, t(goal), t(wvec))
    x0 = _kernel_start_states(t(s0).T.contiguous(), mu)
    got = Emulated(packed[0], sd, AD, HID).costs(x0, t(acts))
    ref = np.asarray(jcem.mlp_rollout_costs_reference(
        jparams, s0, acts, goal, wvec, jnorm))
    assert got.shape == (s0.shape[0],)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
