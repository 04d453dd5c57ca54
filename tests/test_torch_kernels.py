"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip on a machine without an NVIDIA card. On the
card run ``python -m pytest tests/test_torch_kernels.py -m cuda``; the
full-size checks are in chip_smoke.py.
"""

import pytest
import torch

from mujoco_mbrl_tpu_torch import ops
from mujoco_mbrl_tpu_torch.models import (EnsembleDynamics, MLPDynamics,
                                          Normalizers)
from mujoco_mbrl_tpu_torch.ops import apgd_solve, cem_rollout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _problem(dev, B, nr, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((B, nr + 4, nr), generator=g, device=dev)
    A = torch.einsum('bij,bik->bjk', G, G) / (nr + 4) + 0.05 * torch.eye(
        nr, device=dev)
    s = torch.diagonal(A, dim1=1, dim2=2).rsqrt()
    Ad = (A * s[:, :, None] * s[:, None, :]).contiguous()
    vec = lambda: torch.randn((B, nr), generator=g, device=dev)
    act = (torch.rand((B, nr), generator=g, device=dev) > 0.15).float()
    mu = torch.zeros(nr, device=dev)
    mu[[5, 8, 11, 14]] = torch.tensor([0.6, 0.8, 1.0, 0.5], device=dev)
    bounds = torch.zeros(nr, device=dev)
    bounds[3] = 0.7
    return Ad, vec(), 0.3 * vec(), vec(), act, mu, bounds


@pytest.mark.parametrize('cold', [True, False])
@pytest.mark.parametrize('eq_rows', [(), (4,)])
def test_apgd_kernel_matches_plain(dev, cold, eq_rows):
    args = _problem(dev, 37, 17, seed=int(cold))
    kw = dict(nonneg=(0, 1, 2), box_rows=(3,), con0=(5, 8, 11, 14),
              iterations=40, cold=cold, eq_rows=eq_rows)
    before = ops.launch_counts['apgd_solve']
    f, v = apgd_solve.apgd_iterate_batched(*args, **kw)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p = apgd_solve.apgd_iterate_plain(*args, **kw)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)


# The dense kernel's three instantiations: one warp per env with one row
# a lane (nr <= 32) or two (33-64, the walker's 56-62 rows), and the block
# per env past 64 rows (up to the dense regime's 96)
@pytest.mark.parametrize('nr', [17, 32, 33, 62, 64, 80, 96])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_kernel_paths_match_plain(dev, nr, cold):
    args = _problem(dev, 37, nr, seed=nr + int(cold))
    cones = tuple(range(nr - 11, nr, 3))  # the last cone wraps to row 0
    mu = torch.zeros(nr, device=dev)
    mu[list(cones)] = 0.8
    bounds = torch.zeros(nr, device=dev)
    bounds[3] = 0.7
    args = args[:5] + (mu, bounds)
    kw = dict(nonneg=(0, 1, 2), box_rows=(3,), con0=cones, iterations=40,
              cold=cold, eq_rows=(4,))
    f, v, its = apgd_solve.apgd_iterate_batched(*args, **kw,
                                                return_iterations=True)
    f_p, v_p, its_p = apgd_solve.apgd_iterate_plain(*args, **kw,
                                                    return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    assert its.dtype == torch.int32 and its.shape == (37,)
    assert int((its.long() - its_p).abs().max()) <= 1


def test_apgd_kernel_rejects_float64(dev):
    args = [a.double() for a in _problem(dev, 4, 17, seed=0)]
    with pytest.raises(ValueError):
        apgd_solve.apgd_iterate_batched(
            *args, nonneg=(0,), box_rows=(), con0=(), iterations=5,
            cold=True)


def _normalizers(dev, sd, ad):
    """Replay-like stats: one near-constant state dim gives large folded
    W1 rows, as a fitted replay does (the states are then drawn from the
    same stats, so the folded product cancels as it does in the loop)."""
    g = torch.Generator(device=dev).manual_seed(7)
    s_std = 0.1 + torch.rand(sd, generator=g, device=dev)
    s_std[3] = 1e-3
    return Normalizers(
        state_mean=torch.randn(sd, generator=g, device=dev), state_std=s_std,
        action_mean=0.1 * torch.randn(ad, generator=g, device=dev),
        action_std=0.5 + torch.rand(ad, generator=g, device=dev))


# sd 20 is the walker's featured state, which the agent plans on: the
# kernels pad it to 24 lanes; 24 (the observation) needs no padding
@pytest.mark.parametrize('sd', [20, 24])
@pytest.mark.parametrize('sampler', ['triangular', 'normal'])
def test_sampler_kernel_matches_plain_cost(dev, sampler, sd):
    B, K, H, ad = 8, 101, 7, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    mean = 0.3 * torch.randn((B, H, ad), generator=g, device=dev)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 3, s0, mean, std, goal, w, K, sampler=sampler)
    assert costs.shape == (B, K) and acts.shape == (B, H, ad, K)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0


def _proposal(dev, B, H, ad, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mean = 0.3 * torch.randn((B, H, ad), generator=g, device=dev)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    return g, mean, std


def _unclipped_noise(acts, mean, std):
    """z = (a - mean) / std, NaN where the action was clipped."""
    z = (acts - mean[..., None]) / std[..., None]
    return torch.where(acts.abs() < 1.0, z, torch.nan)


@pytest.mark.parametrize('sd', [20, 24])
@pytest.mark.parametrize('sampler', ['triangular', 'normal', 'spline4'])
def test_ensemble_kernel_matches_plain_cost(dev, sampler, sd):
    # K = 60, n = 4: the antithetic partner of candidate k (k + 30) belongs
    # to member (k + 2) % 4, so pairs straddle members
    B, K, n, H, ad = 8, 60, 4, 7, 6
    params = EnsembleDynamics(MLPDynamics(sd, ad), n).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 1)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    norms = _normalizers(dev, sd, ad)
    s0 = norms.state_mean + norms.state_std * s0
    before = ops.launch_counts['cem_sample_rollout_ens']
    costs, acts = cem_rollout.mlp_sample_rollout_costs_ensemble(
        params, 3, s0, mean, std, goal, w, K, n, normalizers=norms,
        sampler=sampler)
    assert ops.launch_counts['cem_sample_rollout_ens'] == before + 1
    assert costs.shape == (B, K) and acts.shape == (B, H, ad, K)
    ref = cem_rollout.rollout_costs_of_actions_ensemble(
        params, s0, acts, goal, w, normalizers=norms)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0
    z = _unclipped_noise(acts, mean, std)
    pair = (z[..., :K // 2] + z[..., K // 2:]).abs()
    assert float(pair.nan_to_num(0.0).max()) < 1e-4


def test_ensemble_kernel_with_one_member_is_the_mlp_kernel(dev):
    B, K, H, sd, ad = 4, 33, 5, 24, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    stacked = {l: {k: v[None] for k, v in p.items()}
               for l, p in params.items()}
    g, mean, std = _proposal(dev, B, H, ad, 2)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    c1, a1 = cem_rollout.mlp_sample_rollout_costs(
        params, 5, s0, mean, std, goal, w, K, sampler='normal')
    c2, a2 = cem_rollout.mlp_sample_rollout_costs_ensemble(
        stacked, 5, s0, mean, std, goal, w, K, 1, sampler='normal')
    torch.testing.assert_close(a2, a1, rtol=0, atol=1e-6)
    torch.testing.assert_close(c2, c1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('sd,H', [(24, 11), (20, 20)])
def test_spline4_kernel_matches_plain_cost(dev, sd, H):
    # (20, 20): the CLI's featured state and horizon, with normalizers
    B, K, ad = 5, 101, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 4)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    norms = _normalizers(dev, sd, ad) if sd == 20 else None
    if norms is not None:
        s0 = norms.state_mean + norms.state_std * s0
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 9, s0, mean, std, goal, w, K, normalizers=norms,
        sampler='spline4')
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w,
                                               normalizers=norms)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    # between observed knots (t = 0, 4, 8) the noise is the renormalised
    # lerp of its two knots
    z = _unclipped_noise(acts, mean, std)
    for t in range(H):
        i, r = divmod(t, 4)
        if r == 0 or 4 * i + 4 >= H:
            continue
        wgt = r / 4
        lerp = ((1 - wgt) * z[:, 4 * i] + wgt * z[:, 4 * i + 4]) / (
            (1 - wgt) ** 2 + wgt ** 2) ** 0.5
        err = (z[:, t] - lerp).abs().nan_to_num(0.0)
        assert float(err.max()) < 1e-4, (t, float(err.max()))


# The tensor-core layout at the edges of what it takes: the CLI's B=5,
# ragged K (odd K leaves the last pair one candidate), antithetic off (16
# own draws a tile), cheetah's sd 17 (state and action share a k-tile),
# and the guarded instantiation that takes every other shape (sd + ad and
# hidden up to 128, weights read from global memory)
@pytest.mark.parametrize('B,K,H,sd,ad,hid,antithetic,sampler', [
    (5, 1000, 20, 20, 6, 50, True, 'spline4'),
    (5, 37, 30, 17, 6, 50, False, 'normal'),
    (3, 101, 7, 19, 6, 50, True, 'triangular'),
    (7, 99, 9, 17, 6, 50, True, 'spline4'),
    (2, 50, 5, 100, 20, 128, True, 'normal'),
    (2, 33, 4, 9, 3, 20, False, 'triangular'),
])
def test_sampler_kernel_shapes(dev, B, K, H, sd, ad, hid, antithetic,
                               sampler):
    params = MLPDynamics(sd, ad, hidden_units=hid).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 6)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    before = ops.launch_counts['cem_sample_rollout']
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 11, s0, mean, std, goal, w, K, antithetic=antithetic,
        sampler=sampler)
    assert ops.launch_counts['cem_sample_rollout'] == before + 1
    assert costs.shape == (B, K) and acts.shape == (B, H, ad, K)
    assert bool(torch.isfinite(costs).all())
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0
    if antithetic:
        z = _unclipped_noise(acts, mean, std)
        Kz = (K + 1) // 2
        pair = (z[..., :K - Kz] + z[..., Kz:]).abs()
        assert float(pair.nan_to_num(0.0).max()) < 1e-4


@pytest.mark.parametrize('B,K,n,H,sd,hid,antithetic', [
    (5, 1000, 5, 20, 20, 50, True),
    (5, 65, 5, 30, 17, 50, True),
    (3, 45, 5, 7, 24, 50, False),
    (2, 40, 4, 5, 100, 128, True),
])
def test_ensemble_kernel_shapes(dev, B, K, n, H, sd, hid, antithetic):
    ad = 6
    params = EnsembleDynamics(MLPDynamics(sd, ad, hidden_units=hid), n).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 8)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs_ensemble(
        params, 13, s0, mean, std, goal, w, K, n, antithetic=antithetic)
    assert costs.shape == (B, K) and acts.shape == (B, H, ad, K)
    ref = cem_rollout.rollout_costs_of_actions_ensemble(params, s0, acts,
                                                        goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    if antithetic:
        z = _unclipped_noise(acts, mean, std)
        Kz = (K + 1) // 2
        pair = (z[..., :K - Kz] + z[..., Kz:]).abs()
        assert float(pair.nan_to_num(0.0).max()) < 1e-4


def test_sampler_kernels_raise_past_128(dev):
    B, K, H, sd, ad = 2, 10, 3, 24, 6
    params = MLPDynamics(sd, ad, hidden_units=136).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 9)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    with pytest.raises(ValueError, match='128'):
        cem_rollout.mlp_sample_rollout_costs(params, 1, s0, mean, std, goal,
                                             w, K)
    stacked = {l: {k: v[None] for k, v in p.items()}
               for l, p in params.items()}
    with pytest.raises(ValueError, match='128'):
        cem_rollout.mlp_sample_rollout_costs_ensemble(
            stacked, 1, s0, mean, std, goal, w, K, 1)


def _factored_problem(dev, B, nr, nv, con0, seed):
    """A factored dual QP batch shaped like solve_apgd's factored branch
    (tests/test_apgd_kernel.py _factored_problem): scaled and
    active-masked Jacobian, dense PSD M^-1, scaled regularizer and
    diagonal; a quarter of the rows active."""
    g = torch.Generator(device=dev).manual_seed(seed)
    J = torch.randn((B, nr, nv), generator=g, device=dev)
    G = torch.randn((B, nv + 2, nv), generator=g, device=dev)
    Minv = (torch.einsum('bij,bik->bjk', G, G) / nv
            + 0.1 * torch.eye(nv, device=dev)).contiguous()
    R = 0.05 + 0.25 * torch.rand((B, nr), generator=g, device=dev)
    active = (torch.rand((B, nr), generator=g, device=dev) > 0.75).float()
    d = torch.einsum('brv,bvw,brw->br', J, Minv, J) + R
    s = d.rsqrt()
    J_s = (J * (s * active)[:, :, None]).contiguous()
    vec = lambda scale: scale * torch.randn((B, nr), generator=g, device=dev)
    mu = torch.zeros(nr, device=dev)
    mu[list(con0)] = 0.7
    return (J_s, Minv, s * s * R * active, s * s * d * active,
            vec(1.0) * active, vec(0.3), vec(1.0), active, mu,
            torch.zeros(nr, device=dev))


# The factored kernel's two paths and the boundary on each side: one env
# per warp up to 160 rows and nv 16 (the exact nv 9 instantiation at the
# cheetah's 146 rows, all non-negative; the guarded one at nv 11 and 16),
# one block per env past that (161 rows; nv 17; the humanoid's 303 x 27;
# nv 40; 320 rows, the last of the 48-register blocks, 321 the first of
# the 64-register ones; 1024 rows, the last any path takes). Rows from
# `c0` on are friction-cone triples, the rows before them non-negative;
# where (nr - c0) % 3 == 2 the last cone's tangents wrap to row 0.
@pytest.mark.parametrize('nr,nv,c0,route', [
    (146, 9, 146, 'warp'), (146, 9, 138, 'warp'), (160, 9, 152, 'warp'),
    (120, 11, 24, 'warp'), (120, 16, 112, 'warp'), (161, 9, 153, 'block'),
    (120, 17, 112, 'block'), (303, 27, 36, 'block'),
    (120, 40, 112, 'block'), (320, 9, 312, 'block'), (321, 9, 313, 'block'),
    (1024, 9, 1013, 'block')])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_factored_kernel_matches_plain(dev, cold, nr, nv, c0, route):
    assert apgd_solve.factored_route(nr, nv) == route
    con0 = tuple(range(c0, nr, 3))
    args = _factored_problem(dev, 37, nr, nv, con0, seed=int(cold))
    kw = dict(nonneg=tuple(range(c0)), box_rows=(), con0=con0,
              iterations=40, cold=cold)
    before = ops.launch_counts['apgd_factored']
    f, v, its = apgd_solve.apgd_iterate_factored(*args, **kw,
                                                 return_iterations=True)
    assert ops.launch_counts['apgd_factored'] == before + 1
    f_p, v_p, its_p = apgd_solve.apgd_iterate_factored_plain(
        *args, **kw, return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    # the same exits, up to an env whose last step rounding decides
    assert its.dtype == torch.int32 and its.shape == (37,)
    assert int((its.long() - its_p).abs().max()) <= 1


# Per-env box bounds (B, nr): friction-loss rows ahead of the limits and
# cones, each env's bound its own (JAX divides the friction loss by each
# env's row scale), on both paths: the cheetah with friction loss (6 + 146
# rows over nv 9, the warp path) and the humanoid (21 + 303 over nv 27,
# the block path); the same bounds shared (nr,) give another answer.
@pytest.mark.parametrize('nr,nv,n_box,c0,route', [
    (152, 9, 6, 152, 'warp'), (324, 27, 21, 57, 'block')])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_factored_kernel_per_env_bounds(dev, cold, nr, nv, n_box, c0,
                                             route):
    assert apgd_solve.factored_route(nr, nv) == route
    con0 = tuple(range(c0, nr, 3))
    args = list(_factored_problem(dev, 37, nr, nv, con0, seed=7 + int(cold)))
    act = args[7].clone()
    act[:, :n_box] = 1.0
    args[7] = act
    args[4] = args[4].abs() + 0.5 * act       # push into the boxes
    g = torch.Generator(device=dev).manual_seed(3)
    bounds = torch.zeros((37, nr), device=dev)
    bounds[:, :n_box] = 0.05 + 0.2 * torch.rand((37, n_box), generator=g,
                                                device=dev)
    args[9] = bounds
    kw = dict(nonneg=tuple(range(n_box, c0)), box_rows=tuple(range(n_box)),
              con0=con0, iterations=40, cold=cold)
    before = ops.launch_counts['apgd_factored']
    f, v = apgd_solve.apgd_iterate_factored(*args, **kw)
    assert ops.launch_counts['apgd_factored'] == before + 1
    f_p, v_p = apgd_solve.apgd_iterate_factored_plain(*args, **kw)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    assert bool((f[:, :n_box].abs() <= bounds[:, :n_box] * (1 + 1e-6)).all())
    assert bool((f[:, :n_box].abs() >= bounds[:, :n_box] * 0.999).any())
    shared = list(args)
    shared[9] = bounds[0].contiguous()
    f_s, _ = apgd_solve.apgd_iterate_factored(*shared, **kw)
    f_sp, _ = apgd_solve.apgd_iterate_factored_plain(*shared, **kw)
    torch.testing.assert_close(f_s, f_sp, rtol=2e-4, atol=2e-4)
    assert not torch.allclose(f_s, f, rtol=2e-4, atol=2e-4)


def test_apgd_factored_kernel_rejects_what_it_does_not_take(dev,
                                                            monkeypatch):
    args = _factored_problem(dev, 4, 146, 9, (), seed=0)
    kw = dict(nonneg=tuple(range(146)), box_rows=(), con0=(),
              iterations=5, cold=True)
    with pytest.raises(ValueError):
        apgd_solve.apgd_iterate_factored(*[a.double() for a in args], **kw)
    big = _factored_problem(dev, 2, 1100, 9, (), seed=0)
    with pytest.raises(ValueError, match='shared memory'):
        apgd_solve.apgd_iterate_factored(
            *big, **dict(kw, nonneg=tuple(range(1100))))
    # the kernel refuses a path that does not take the shape
    wide = _factored_problem(dev, 4, 161, 9, (), seed=0)
    monkeypatch.setattr(apgd_solve, 'factored_route', lambda nr, nv: 'warp')
    with pytest.raises(RuntimeError, match='CUDA error'):
        apgd_solve.apgd_iterate_factored(
            *wide, **dict(kw, nonneg=tuple(range(161))))


@pytest.mark.parametrize('normalized', [False, True])
def test_rollout_costs_kernel_matches_plain(dev, normalized):
    N, H, sd, ad = 3 * 201, 9, 17, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    norms = _normalizers(dev, sd, ad) if normalized else None
    s0T = torch.randn((sd, N), generator=g, device=dev)
    if norms is not None:
        s0T = norms.state_mean[:, None] + norms.state_std[:, None] * s0T
    aT = torch.rand((H, ad, N), generator=g, device=dev) * 2 - 1
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    before = ops.launch_counts['cem_rollout_costs']
    costs = cem_rollout.mlp_rollout_costs_t(params, s0T, aT, goal, w,
                                            normalizers=norms)
    assert ops.launch_counts['cem_rollout_costs'] == before + 1
    ref = cem_rollout.mlp_rollout_costs_reference(
        params, s0T.T, aT.transpose(1, 2), goal, w, normalizers=norms)
    assert costs.shape == (N,)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    # the (K, sd) / (H, K, ad) form is the same launch on transposed input
    costs2 = cem_rollout.mlp_rollout_costs(
        params, s0T.T, aT.transpose(1, 2), goal, w, normalizers=norms)
    torch.testing.assert_close(costs2, costs, rtol=0, atol=0)


# N not a multiple of 16 (the last tile part empty) at the walker widths
# (sd 24, the exact (4, 7, 3) instantiation) and cheetah's (sd 17, exact
# (3, 7, 3)); fewer candidates than one tile; the guarded instantiation
# (weights from global memory) at a shape no exact one takes
@pytest.mark.parametrize('N,H,sd,ad,hid', [
    (1000 + 7, 6, 24, 6, 50), (37, 9, 17, 6, 50), (5, 4, 24, 6, 50),
    (203, 5, 40, 6, 64), (64, 3, 100, 20, 128)])
def test_rollout_costs_kernel_shapes(dev, N, H, sd, ad, hid):
    params = MLPDynamics(sd, ad, hidden_units=hid).init(
        torch.Generator().manual_seed(1), device=dev)
    g = torch.Generator(device=dev).manual_seed(N)
    s0T = torch.randn((sd, N), generator=g, device=dev)
    aT = torch.rand((H, ad, N), generator=g, device=dev) * 2 - 1
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs = cem_rollout.mlp_rollout_costs_t(params, s0T, aT, goal, w)
    ref = cem_rollout.mlp_rollout_costs_reference(
        params, s0T.T, aT.transpose(1, 2), goal, w)
    assert costs.shape == (N,) and bool(torch.isfinite(costs).all())
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)


def test_rollout_costs_kernel_raises_past_128(dev):
    N, H, sd, ad = 20, 3, 24, 6
    params = MLPDynamics(sd, ad, hidden_units=136).init(
        torch.Generator().manual_seed(0), device=dev)
    s0T = torch.zeros((sd, N), device=dev)
    aT = torch.zeros((H, ad, N), device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    with pytest.raises(ValueError, match='128'):
        cem_rollout.mlp_rollout_costs_t(params, s0T, aT, goal, w)


def test_non_fused_cem_launches_rollout_costs_per_iteration(dev):
    from mujoco_mbrl_tpu_torch.planners import cem_batched
    B, K, H, sd, ad = 4, 50, 6, 17, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    s0 = torch.randn((B, sd), device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    ops.reset_launch_counts()
    traj = cem_batched([1, 2, 3], s0, H, ad, num_candidates=K,
                       num_elites=5, rollout_costs_fn=lambda s, a: (
                           cem_rollout.mlp_rollout_costs_t(params, s, a,
                                                           goal, w)))
    assert ops.launch_counts['cem_rollout_costs'] == 3
    assert ops.launch_counts['cem_sample_rollout'] == 0
    assert traj.actions.shape == (H, B, ad)


# The contact-free domains' solves: the reacher's one limit row and the
# point_mass's two, through the one-row-a-lane warp kernel with 31 or 30
# empty lanes; limit rows active (past the limit) and inactive, cold and
# warm. Ad is not scaled to a unit diagonal here: a unit-diagonal 2 x 2
# block has the flat power-iteration start as an exact eigenvector, and
# rounding then decides which eigenvalue the step size takes (the
# reference's behaviour, which chip_smoke.py's allowance covers)
@pytest.mark.parametrize('nr', [1, 2])
@pytest.mark.parametrize('cold', [True, False])
@pytest.mark.parametrize('active', [1.0, 0.0])
def test_apgd_kernel_one_and_two_rows(dev, nr, cold, active):
    B = 37
    g = torch.Generator(device=dev).manual_seed(nr)
    G = torch.randn((B, nr + 1, nr), generator=g, device=dev)
    A = torch.einsum('bij,bik->bjk', G, G) + 0.1 * torch.eye(nr, device=dev)
    Ad = (A * active).contiguous()
    rhs = torch.randn((B, nr), generator=g, device=dev) * active
    f0 = torch.rand((B, nr), generator=g, device=dev)
    v0 = torch.randn((B, nr), generator=g, device=dev)
    act = torch.full((B, nr), active, device=dev)
    zero = torch.zeros(nr, device=dev)
    kw = dict(nonneg=tuple(range(nr)), box_rows=(), con0=(), iterations=60,
              cold=cold)
    f, v, its = apgd_solve.apgd_iterate_batched(
        Ad, rhs, f0, v0, act, zero, zero, **kw, return_iterations=True)
    f_p, v_p, its_p = apgd_solve.apgd_iterate_plain(
        Ad, rhs, f0, v0, act, zero, zero, **kw, return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    assert int((its.long() - its_p).abs().max()) <= 1
    if active:
        assert float(f.abs().max()) > 1e-2
    else:
        assert float(f.abs().max()) == 0.0


# The small models of the contact-free domains (reacher 6 + 2, point_mass
# 4 + 2, pendulum 3 + 1; hidden 50) take the exact (1, 7, 1)
# instantiation of every tensor-core kernel
@pytest.mark.parametrize('sd,ad', [(6, 2), (4, 2), (3, 1)])
@pytest.mark.parametrize('sampler', ['normal', 'spline4'])
def test_small_model_exact_instantiation(dev, sd, ad, sampler):
    B, K, H, n = 6, 101, 9, 5
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(2),
                                      device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 9)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 17, s0, mean, std, goal, w, K, sampler=sampler)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    # the given-action kernel (#4) on the same actions
    flat = acts.permute(1, 2, 0, 3).reshape(H, ad, B * K).contiguous()
    s0T = s0.T[:, :, None].expand(sd, B, K).reshape(sd, B * K).contiguous()
    given = cem_rollout.mlp_rollout_costs_t(params, s0T, flat, goal, w)
    torch.testing.assert_close(given.reshape(B, K), ref, rtol=1e-4,
                               atol=1e-4)
    # the ensemble sampler (#5 / #6)
    ens = EnsembleDynamics(MLPDynamics(sd, ad), n).init(
        torch.Generator().manual_seed(3), device=dev)
    c_e, a_e = cem_rollout.mlp_sample_rollout_costs_ensemble(
        ens, 19, s0, mean, std, goal, w, 100, n)
    r_e = cem_rollout.rollout_costs_of_actions_ensemble(ens, s0, a_e, goal,
                                                        w)
    torch.testing.assert_close(c_e, r_e, rtol=1e-4, atol=1e-4)


# A layout no exact instantiation takes (sd 40 + ad 6, hidden 64: 8
# hidden tiles) goes to the guarded (16, 16, 16) instantiation, weights
# read from global memory
@pytest.mark.parametrize('sampler', ['normal', 'spline4'])
def test_sampler_guarded_instantiation(dev, sampler):
    B, K, H, sd, ad = 4, 101, 9, 40, 6
    params = MLPDynamics(sd, ad, hidden_units=64).init(
        torch.Generator().manual_seed(4), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 10)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 23, s0, mean, std, goal, w, K, sampler=sampler)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0


# The humanoid's widths (ad 21, hidden 50): the bench's 67-dim observation
# (tiles (11, 7, 9)) and the CLI's 60-dim featured state (11, 7, 8) take
# the sized wide instantiations of every tensor-core kernel (run-time loop
# bounds, weights in shared memory beside the warps' scratch), not the
# guarded one
@pytest.mark.parametrize('sd,ad', [(67, 21), (60, 21)])
@pytest.mark.parametrize('sampler', ['normal', 'spline4'])
def test_humanoid_instantiations(dev, sd, ad, sampler):
    B, K, H, n = 6, 101, 9, 5
    assert cem_rollout.sampler_instantiation(K, H, sd, ad, 50) == (
        11, 7, (sd + 7) // 8, False, True)
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(5),
                                      device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 11)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 29, s0, mean, std, goal, w, K, sampler=sampler)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0
    # the given-action kernel (#4) on the same actions
    flat = acts.permute(1, 2, 0, 3).reshape(H, ad, B * K).contiguous()
    s0T = s0.T[:, :, None].expand(sd, B, K).reshape(sd, B * K).contiguous()
    given = cem_rollout.mlp_rollout_costs_t(params, s0T, flat, goal, w)
    torch.testing.assert_close(given.reshape(B, K), ref, rtol=1e-4,
                               atol=1e-4)
    # the ensemble sampler (#5 / #6)
    ens = EnsembleDynamics(MLPDynamics(sd, ad), n).init(
        torch.Generator().manual_seed(6), device=dev)
    c_e, a_e = cem_rollout.mlp_sample_rollout_costs_ensemble(
        ens, 31, s0, mean, std, goal, w, 100, n)
    r_e = cem_rollout.rollout_costs_of_actions_ensemble(ens, s0, a_e, goal,
                                                        w)
    torch.testing.assert_close(c_e, r_e, rtol=1e-4, atol=1e-4)


# #7's block path on the solves the port's humanoid step builds (303 rows,
# nv 27): 64 poses in floor contact with random root orientations and
# joints, a cold substep, then a warm one from its forces. f and v of every
# env agree with the plain version within rtol = atol = 2e-4, but for an
# env that rounding decides: the plain version run in float64 on the same
# inputs moves it beyond that tolerance of the float32 plain too (a small
# active block with a unit diagonal has the flat start as an exact
# eigenvector, ROADMAP Queue 3).
def test_apgd_factored_block_path_on_humanoid_solves(dev, monkeypatch):
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics.model import State

    m = suite.load('humanoid', 'walk', device=dev).model
    B = 64
    g = torch.Generator(device=dev).manual_seed(31)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    qpos = m.qpos0.expand(B, m.nq).clone()
    qpos[:, 2] = 0.5 + 0.7 * u(B)
    quat = torch.randn((B, 4), generator=g, device=dev)
    qpos[:, 3:7] = quat / torch.linalg.vector_norm(quat, dim=1,
                                                   keepdim=True)
    lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
    qpos[:, 7:] = lo + u(B, 21) * (hi - lo)
    qvel = torch.randn((B, m.nv), generator=g, device=dev)
    captured = []
    real = apgd_solve.apgd_iterate_factored
    monkeypatch.setattr(apgd_solve, 'apgd_iterate_factored', lambda *a, **k: (
        captured.append((tuple(x.clone() for x in a), dict(k))),
        real(*a, **k))[1])
    zero = torch.zeros((B, m.nu), device=dev)
    s1, f, v = engine.step_warm(
        m, State(qpos=qpos, qvel=qvel, time=torch.zeros(B, device=dev)),
        zero)
    engine.step_warm(m, s1, zero, warm_f=f, warm_v=v)
    assert [kw['cold'] for _, kw in captured] == [True, False]
    assert apgd_solve.factored_route(303, 27) == 'block'
    for args, kw in captured:
        assert args[0].shape == (B, 303, 27) and int(args[7].sum()) > B
        f_k, v_k = real(*args, **kw)
        f_p, v_p = apgd_solve.apgd_iterate_factored_plain(*args, **kw)
        close = lambda a, b: torch.isclose(a, b, rtol=2e-4,
                                           atol=2e-4).all(1)
        odd = ~close(f_k, f_p) | ~close(v_k, v_p)
        if bool(odd.any()):
            f64, v64 = apgd_solve.apgd_iterate_factored_plain(
                *[a[odd].double() for a in args[:8]],
                *[a.double() for a in args[8:]], **kw)
            moved = (~close(f64, f_p[odd].double())
                     | ~close(v64, v_p[odd].double()))
            assert bool(moved.all()), odd.nonzero()[:, 0].tolist()


# The hopper's solve: 88 rows (its 4 joint limits, then 21 contact points
# of 4 pyramid facets, all non-negative), past the warp path's 64, so one
# block per env; limit rows active at random, a contact's 4 facets
# together; cold and warm
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_kernel_hopper_rows(dev, cold):
    B, nr = 64, 88
    Ad, rhs, f0, v0, _, _, _ = _problem(dev, B, nr, seed=88 + int(cold))
    g = torch.Generator(device=dev).manual_seed(89)
    act = torch.cat([(torch.rand((B, 4), generator=g, device=dev) < 0.3),
                     (torch.rand((B, 21), generator=g, device=dev) < 0.4
                      ).repeat_interleave(4, dim=1)], 1).float()
    zeros = torch.zeros(nr, device=dev)
    args = (Ad, rhs * act, f0 * act, v0, act, zeros, zeros)
    kw = dict(nonneg=tuple(range(nr)), box_rows=(), con0=(), iterations=60,
              cold=cold, eq_rows=())
    before = ops.launch_counts['apgd_solve']
    f, v = apgd_solve.apgd_iterate_batched(*args, **kw)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p = apgd_solve.apgd_iterate_plain(*args, **kw)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    assert float((f * (1 - act)).abs().max()) == 0.0


# The hopper bench's observation-space model (sd 15, ad 4: two state
# tiles) takes the sized (3, 7, 2) instantiation
@pytest.mark.parametrize('sampler', ['triangular', 'spline4'])
def test_sampler_kernel_hopper_observation_tiles(dev, sampler):
    B, K, H, sd, ad = 9, 200, 12, 15, 4
    assert cem_rollout.sampler_instantiation(K, H, sd, ad, 50) == (
        3, 7, 2, True, True)
    params = MLPDynamics(sd, ad, hidden_units=50).init(
        torch.Generator().manual_seed(2), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 15)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 4, s0, mean, std, goal, w, K, sampler=sampler)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0


# ---- the bf16 instantiations (compute_dtype=torch.bfloat16) against the
# plain bf16 versions: at most 1% of candidates beyond rtol = atol = 1e-5
# (those whose bf16 rounding an accumulation order decides), every one
# within 1e-3; and JAX's bf16 selfcheck tolerance against float32

def _bf16_normalizers(dev, sd, ad):
    """_normalizers without the near-constant state dim: the bf16 mode
    rounds the uncentred fold, as JAX's does, so a state std of 1e-3 would
    put the float32 reference out of reach of bf16 weights."""
    norms = _normalizers(dev, sd, ad)
    norms.state_std[3] = 0.5
    return norms


def _hold_bf16(costs, ref16, ref32):
    gap, scale = (costs - ref16).abs(), 1.0 + ref16.abs()
    assert bool((gap <= 1e-3 * scale).all()), float((gap / scale).max())
    assert int((gap > 1e-5 * scale).sum()) <= 0.01 * costs.numel()
    torch.testing.assert_close(costs, ref32, rtol=5e-2, atol=5e-1)


@pytest.mark.parametrize('sd,ad,hid,tiles', [
    (24, 6, 50, (2, 4, 3, True, True)), (20, 6, 50, (2, 4, 3, True, True)),
    (67, 21, 50, (6, 4, 9, False, True)),
    (40, 6, 64, (8, 8, 16, False, False))])
@pytest.mark.parametrize('sampler', ['triangular', 'normal', 'spline4'])
def test_bf16_sampler_matches_plain_bf16(dev, sampler, sd, ad, hid, tiles):
    B, K, H = 8, 101, 9
    bf = torch.bfloat16
    assert cem_rollout.sampler_instantiation(K, H, sd, ad, hid,
                                             compute_dtype=bf) == tiles
    params = MLPDynamics(sd, ad, hidden_units=hid).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 1)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    before = dict(ops.launch_counts)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 3, s0, mean, std, goal, w, K, sampler=sampler,
        compute_dtype=bf)
    assert ops.launch_counts['cem_sample_rollout_bf16'] == (
        before['cem_sample_rollout_bf16'] + 1)
    assert ops.launch_counts['cem_sample_rollout'] == before[
        'cem_sample_rollout']
    assert acts.dtype == bf and acts.shape == (B, H, ad, K)
    assert float(acts.float().abs().max()) <= 1.0
    of = cem_rollout.rollout_costs_of_actions
    _hold_bf16(costs, of(params, s0, acts, goal, w, compute_dtype=bf),
               of(params, s0, acts, goal, w))


def test_bf16_ensemble_matches_plain_bf16(dev):
    B, K, n, H, sd, ad = 8, 60, 4, 7, 24, 6
    bf = torch.bfloat16
    params = EnsembleDynamics(MLPDynamics(sd, ad), n).init(
        torch.Generator().manual_seed(0), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 1)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    norms = _bf16_normalizers(dev, sd, ad)
    costs, acts = cem_rollout.mlp_sample_rollout_costs_ensemble(
        params, 3, s0, mean, std, goal, w, K, n, normalizers=norms,
        compute_dtype=bf)
    assert acts.dtype == bf
    of = cem_rollout.rollout_costs_of_actions_ensemble
    _hold_bf16(costs, of(params, s0, acts, goal, w, norms, compute_dtype=bf),
               of(params, s0, acts, goal, w, norms))


@pytest.mark.parametrize('sd,hid', [(17, 50), (24, 50), (40, 64)])
def test_bf16_rollout_costs_matches_plain_bf16(dev, sd, hid):
    N, H, ad = 1000, 9, 6
    bf = torch.bfloat16
    params = MLPDynamics(sd, ad, hidden_units=hid).init(
        torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    s0T = torch.randn((sd, N), generator=g, device=dev)
    aT = torch.rand((H, ad, N), generator=g, device=dev) * 2 - 1
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    norms = _bf16_normalizers(dev, sd, ad)
    before = ops.launch_counts['cem_rollout_costs_bf16']
    costs = cem_rollout.mlp_rollout_costs_t(params, s0T, aT, goal, w, norms,
                                            compute_dtype=bf)
    assert ops.launch_counts['cem_rollout_costs_bf16'] == before + 1
    ref = lambda **kw: cem_rollout.mlp_rollout_costs_reference(
        params, s0T.T, aT.transpose(1, 2), goal, w, norms, **kw)
    _hold_bf16(costs, ref(compute_dtype=bf), ref())


# finger's row layout: a box row (per-env bounds, as JAX's vmapped
# iterate takes them once each env's row scale divides them), two
# non-negative limit rows, then cone triples (3, 4, 5) ... (36, 37, 38)
# across the warp path's lane and slot boundary, to its 400-iteration
# cap; and the same per-env bounds at the block path's 80 rows
@pytest.mark.parametrize('nr,path', [(39, 'warp'), (80, 'block')])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_kernel_per_env_bounds(dev, nr, path, cold):
    B = 64
    Ad, rhs, f0, v0, act, _, _ = _problem(dev, B, nr, seed=39 + int(cold))
    cones = tuple(range(3, nr - 2, 3))
    mu = torch.zeros(nr, device=dev)
    mu[list(cones)] = 1.0
    g = torch.Generator(device=dev).manual_seed(40)
    bounds = torch.zeros((B, nr), device=dev)
    bounds[:, 0] = 0.05 + torch.rand(B, generator=g, device=dev)
    args = (Ad, 3.0 * rhs, f0, v0, act, mu, bounds)
    kw = dict(nonneg=(1, 2), box_rows=(0,), con0=cones, iterations=400,
              cold=cold, eq_rows=())
    before = ops.launch_counts['apgd_solve']
    f, v = apgd_solve.apgd_iterate_batched(*args, **kw)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p = apgd_solve.apgd_iterate_plain(*args, **kw)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    # each env's box row stays in its own bound, and some sit on it
    assert bool((f[:, 0].abs() <= bounds[:, 0] * (1 + 1e-6)).all())
    on = (f[:, 0].abs() - bounds[:, 0]).abs() < 1e-5 * bounds[:, 0]
    assert int(on.sum()) >= 4
    # one bound shared by every env reads the same as it broadcast
    shared = args[:6] + (bounds[0].contiguous(),)
    f_s, _ = apgd_solve.apgd_iterate_batched(*shared, **kw)
    f_b, _ = apgd_solve.apgd_iterate_batched(
        *args[:6], bounds[:1].expand(B, nr).contiguous(), **kw)
    torch.testing.assert_close(f_s, f_b, rtol=0, atol=0)


def _dense_problem(dev, B, nr, seed):
    """A dense solve laid out as the manipulator's and stacker's: a box row
    with per-env bounds (B, nr), the equality row, seven non-negative limit
    rows, then cone triples (9, 10, 11), ... across every warp boundary;
    the box and equality rows always active, a third of the limits and a
    sixth of the triples active, and Ad zero in the inactive rows and
    columns, as solve_apgd masks it."""
    Ad, rhs, f0, v0, _, _, _ = _problem(dev, B, nr, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    cones = tuple(range(9, nr - 2, 3))
    act = torch.zeros((B, nr), device=dev)
    act[:, :2] = 1.0
    act[:, 2:9] = (torch.rand((B, 7), generator=g, device=dev) < 0.33).float()
    tri = (torch.rand((B, len(cones)), generator=g, device=dev) < 0.17)
    act[:, 9:9 + 3 * len(cones)] = tri.float().repeat_interleave(3, dim=1)
    Ad = (Ad * act[:, :, None] * act[:, None, :]).contiguous()
    mu = torch.zeros(nr, device=dev)
    mu[list(cones)] = 0.7
    bounds = torch.zeros((B, nr), device=dev)
    bounds[:, 0] = 0.05 + torch.rand(B, generator=g, device=dev)
    kw = dict(nonneg=tuple(range(2, 9)) + tuple(range(9 + 3 * len(cones),
                                                      nr)),
              box_rows=(0,), con0=cones, eq_rows=(1,), iterations=60)
    return (Ad, 3.0 * rhs, f0, v0, act, mu, bounds), kw


# #1's global path (Ad in device memory, the active submatrix only) past
# the row count where the block path's shared memory runs out (238 | 239),
# at the manipulator's bring_ball (452) and the stacker's stack_4 (977)
# rows: equality polish, cone triples across warp boundaries, a box row
# with per-env bounds, cold and warm
@pytest.mark.parametrize('nr,path', [(238, 'block'), (239, 'global'),
                                     (452, 'global'), (977, 'global')])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_kernel_global_path(dev, nr, path, cold):
    assert apgd_solve.dense_route(nr) == path
    lib = apgd_solve._build.library('apgd_solve', apgd_solve._SIGNATURES)
    assert lib.apgd_smem_bytes(nr) == apgd_solve.block_smem_bytes(nr)
    assert (lib.apgd_smem_bytes(nr) <= apgd_solve.MAX_SHARED_BYTES) == (
        path == 'block')
    args, kw = _dense_problem(dev, 48, nr, seed=nr + int(cold))
    before = ops.launch_counts['apgd_solve']
    f, v, its = apgd_solve.apgd_iterate_batched(*args, cold=cold, **kw,
                                                return_iterations=True)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p, its_p = apgd_solve.apgd_iterate_plain(
        *args, cold=cold, **kw, return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    # the global path sums each row over the active columns lane by lane
    # and by shuffles, the plain version by bmm: an env near the exit
    # test may stop an iteration or two apart, f agreeing as held above
    assert int((its.long() - its_p).abs().max()) <= 2
    act, bounds = args[4], args[6]
    assert float((f * (1 - act)).abs().max()) == 0.0
    assert bool((f[:, 0].abs() <= bounds[:, 0] * (1 + 1e-6)).all())
    assert float(f[:, 1].abs().max()) > 1e-3       # the equality row works


def _quadruped_problem(dev, B, nr, seed):
    """A masked batch of the quadruped's row layout at nr rows: 4
    tendon-equality rows (active), then only non-negative rows: 16 joint
    limits and 104 frictionless leg contacts (each active 1 time in 5),
    then pyramids of 4 facets (and, at fetch's 914 rows, 21 of 10, the
    ball's condim 6), a pyramid active or not as one contact (1 in 5);
    Ad zero in the inactive rows and columns, as solve_apgd masks it."""
    Ad, rhs, f0, v0, _, _, _ = _problem(dev, B, nr, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    sizes = [4] * ((nr - 124) // 4) if nr != 914 else [4] * 145 + [10] * 21
    assert 124 + sum(sizes) == nr
    act = torch.ones((B, nr), device=dev)
    act[:, 4:124] = (torch.rand((B, 120), generator=g, device=dev)
                     < 0.2).float()
    on = (torch.rand((B, len(sizes)), generator=g, device=dev) < 0.2).float()
    act[:, 124:] = on.repeat_interleave(torch.tensor(sizes, device=dev),
                                        dim=1)
    Ad = (Ad * act[:, :, None] * act[:, None, :]).contiguous()
    zeros = torch.zeros(nr, device=dev)
    kw = dict(nonneg=tuple(range(4, nr)), box_rows=(), con0=(),
              eq_rows=(0, 1, 2, 3), iterations=60)
    return (Ad, 3.0 * rhs, f0, v0, act, zeros, zeros), kw


# #1's global path at the quadruped's rows: walk and run (240), escape
# (356, its terrain's pyramids) and fetch (914, the condim-6 ball's ten
# facets a contact), four equality rows polished, cold and warm
@pytest.mark.parametrize('nr', [240, 356, 914])
@pytest.mark.parametrize('cold', [True, False])
def test_apgd_kernel_global_path_quadruped_rows(dev, nr, cold):
    assert apgd_solve.dense_route(nr) == 'global'
    args, kw = _quadruped_problem(dev, 40, nr, seed=nr + int(cold))
    before = ops.launch_counts['apgd_solve']
    f, v, its = apgd_solve.apgd_iterate_batched(*args, cold=cold, **kw,
                                                return_iterations=True)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p, its_p = apgd_solve.apgd_iterate_plain(
        *args, cold=cold, **kw, return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    # an env creeping toward the exit test near the cap may stop a few
    # iterations apart (3 at 914 rows warm on the card), f agreeing as
    # held above
    assert int((its.long() - its_p).abs().max()) <= 4
    act = args[4]
    assert float((f * (1 - act)).abs().max()) == 0.0
    assert float(f[:, 4:].min()) >= 0.0
    assert float(f[:, :4].abs().max()) > 1e-3      # the equality rows work


def test_apgd_kernel_refuses_past_1024_rows(dev):
    args, kw = _dense_problem(dev, 2, 1025, seed=0)
    with pytest.raises(ValueError, match='1024'):
        apgd_solve.apgd_iterate_batched(*args, cold=True, **kw)


# The manipulator's featured state (sd 29, ad 5) takes the sized (5, 7, 4)
# instantiation with run-time loop bounds (the exact one spills)
@pytest.mark.parametrize('sampler', ['normal', 'spline4'])
def test_sampler_kernel_manipulator_tiles(dev, sampler):
    B, K, H, sd, ad = 9, 200, 12, 29, 5
    assert cem_rollout.sampler_instantiation(K, H, sd, ad, 50) == (
        5, 7, 4, False, True)
    params = MLPDynamics(sd, ad, hidden_units=50).init(
        torch.Generator().manual_seed(3), device=dev)
    g, mean, std = _proposal(dev, B, H, ad, 16)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    w = torch.rand(sd, generator=g, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 5, s0, mean, std, goal, w, K, sampler=sampler)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0


def _dense_factors_problem(dev, ks, nr=4352, nv=62, seed=0):
    """A dense-regime solve past 1024 rows shaped like solve_apgd's
    humanoid_cmu solves: scaled and active-masked J~ (B, nr, nv), a dense
    PSD M^-1, Rs and rhs zero off the active rows; env b has ks[b] active
    rows, spread over all nr."""
    B = len(ks)
    g = torch.Generator(device=dev).manual_seed(seed)
    J = torch.randn((B, nr, nv), generator=g, device=dev)
    G = torch.randn((B, nv + 2, nv), generator=g, device=dev)
    Minv = (torch.einsum('bij,bik->bjk', G, G) / nv
            + 0.1 * torch.eye(nv, device=dev)).contiguous()
    R = 0.05 + 0.25 * torch.rand((B, nr), generator=g, device=dev)
    active = torch.zeros((B, nr), device=dev)
    for b, k in enumerate(ks):
        rows = torch.randperm(nr, generator=g, device=dev)[:k]
        active[b, rows] = 1.0
    d = torch.einsum('brv,bvw,brw->br', J, Minv, J) + R
    s = d.rsqrt()
    J_s = (J * (s * active)[:, :, None]).contiguous()
    vec = lambda: torch.randn((B, nr), generator=g, device=dev)
    return (J_s, Minv, s * s * R * active, vec() * active, 0.3 * vec(),
            vec(), active)


# The dense iterate on factors at humanoid_cmu's 4,352 x 62: no active
# row, tens, several hundred (all of J~'s active rows staged in shared
# memory), past the 747 that fit (the rest read from device memory) and
# every row; cold, warm from a converged power vector and warm from a
# random one, which the Rayleigh guard finds stale in envs where the
# staging runs out (the row-sum bound over staged rows and rows in device
# memory)
@pytest.mark.parametrize('start', ['cold', 'warm', 'stale'])
def test_apgd_dense_factors_kernel_matches_plain(dev, start):
    ks = [0, 37, 400, 748, 1500, 4352]
    assert apgd_solve.dense_factors_stage_rows(400, 62) == 400
    assert apgd_solve.dense_factors_stage_rows(748, 62) < 748
    J_s, Minv, Rs, rhs, f0, v0, act = _dense_factors_problem(dev, ks)
    kw = dict(nonneg=tuple(range(4352)), iterations=60)
    if start == 'warm':
        _, v0 = apgd_solve.apgd_iterate_dense_factors_plain(
            J_s, Minv, Rs, rhs, f0, v0, act, cold=True, **kw)
    args = (J_s, Minv, Rs, rhs, f0, v0, act)
    stale = apgd_solve.dense_factors_warm_stale(J_s, Minv, Rs, v0)
    if start == 'stale':
        assert bool(stale[3:].any())
    elif start == 'warm':
        assert not bool(stale.any())
    before = ops.launch_counts['apgd_dense_factors']
    f, v, its = apgd_solve.apgd_iterate_dense_factors(
        *args, cold=start == 'cold', **kw, return_iterations=True)
    assert ops.launch_counts['apgd_dense_factors'] == before + 1
    f_p, v_p, its_p = apgd_solve.apgd_iterate_dense_factors_plain(
        *args, cold=start == 'cold', **kw, return_iterations=True)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)
    assert its.dtype == torch.int32 and its.shape == (len(ks),)
    assert int((its.long() - its_p).abs().max()) <= 1
    assert float((f * (1 - act)).abs().max()) == 0.0
    assert float((v * (1 - act)).abs().max()) == 0.0


def test_apgd_dense_factors_kernel_rejects_what_it_does_not_take(dev):
    args = _dense_factors_problem(dev, [10, 20], nr=1100, nv=9)
    kw = dict(nonneg=tuple(range(1100)), iterations=5, cold=True)
    with pytest.raises(ValueError, match='float32'):
        apgd_solve.apgd_iterate_dense_factors(*[a.double() for a in args],
                                              **kw)
    with pytest.raises(ValueError, match='non-negative'):
        apgd_solve.apgd_iterate_dense_factors(
            *args, **dict(kw, nonneg=tuple(range(1099))))
    big = _dense_factors_problem(dev, [10], nr=9000, nv=9)
    with pytest.raises(ValueError, match='shared memory'):
        apgd_solve.apgd_iterate_dense_factors(
            *big, **dict(kw, nonneg=tuple(range(9000))))
