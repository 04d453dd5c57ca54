"""The bf16 mode of the CEM kernels (compute_dtype=torch.bfloat16), port
against the JAX package.

The plain bf16 versions (what the CUDA bf16 instantiations are held to on
the card) are compared with the JAX package's bf16 Pallas kernel #4
(``mlp_rollout_costs_t(..., compute_dtype=jnp.bfloat16, interpret=True)``)
on the same numpy inputs at the walker widths (sd 24, ad 6, hidden 50, H 8,
N 256), without and with normalizers: rtol = atol = 2e-5 (float32 sums of
the same bf16 operands in another order; the JAX kernel as it runs here
rounds the product (s - goal) w and a / alpha_action only as float32, and
so does the port). Their median relative gap to JAX bf16 must be at least
10x below their gap to JAX float32 (about 1e-3): the port really rounds to
bf16. The samplers' plain versions (the single MLP and the ensemble,
member k % n) are held on the costs of their own bf16 actions to JAX's
bf16 #4 the same way. The bf16 packer's fragment map is read back lane by
lane against the m16n8k16 layout, and one GoalStateAgent collection runs
with ``kernel_kwargs={'compute_dtype': torch.bfloat16}``. The kernels
themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.models import EnsembleDynamics as JEns
from mujoco_mbrl_tpu.models import MLPDynamics as JMLP
from mujoco_mbrl_tpu.models import Normalizers as JNorm
from mujoco_mbrl_tpu.ops import cem_rollout as jcem
from mujoco_mbrl_tpu_torch import agents, convert, envs, planners
from mujoco_mbrl_tpu_torch.models import MLPDynamics
from mujoco_mbrl_tpu_torch.models import train as Mt
from mujoco_mbrl_tpu_torch.ops import cem_mma, cem_rollout

SD, AD, HID, H, N = 24, 6, 50, 8, 256
TOL = 2e-5
BF16 = torch.bfloat16


def _norm(rng, sd=SD, ad=AD):
    return {k: np.asarray(v, np.float32) for k, v in dict(
        state_mean=rng.normal(size=sd), state_std=0.1 + rng.uniform(size=sd),
        action_mean=0.1 * rng.normal(size=ad),
        action_std=0.5 + rng.uniform(size=ad)).items()}


def _inputs(seed, normalized):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, JMLP(SD, AD, HID).init(
        jax.random.PRNGKey(seed)))
    norm = _norm(rng) if normalized else None
    s0 = rng.normal(size=(N, SD)).astype(np.float32)
    if norm is not None:
        s0 = norm['state_mean'] + norm['state_std'] * s0
    acts = rng.uniform(-1, 1, size=(H, N, AD)).astype(np.float32)
    goal = rng.normal(size=SD).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=SD).astype(np.float32)
    return params, norm, s0, acts, goal, w


def _jax_costs_t(params, norm, s0, acts, goal, w, alpha_action, dtype):
    """JAX's #4 in interpret mode: s0 (N, sd), acts (H, N, ad)."""
    jnorm = None if norm is None else JNorm(
        **{k: jnp.asarray(v) for k, v in norm.items()})
    return np.asarray(jcem.mlp_rollout_costs_t(
        params, jnp.asarray(s0.T), jnp.asarray(acts.transpose(0, 2, 1)),
        jnp.asarray(goal), jnp.asarray(w), jnorm, alpha_action=alpha_action,
        compute_dtype=dtype, interpret=True, tile=128))


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def _held(ours, jb, jf):
    """Within TOL of JAX bf16, and 10x closer to it than to JAX float32 by
    median relative gap."""
    np.testing.assert_allclose(ours, jb, rtol=TOL, atol=TOL)
    gap_b, gap_f = np.median(_rel(ours, jb)), np.median(_rel(ours, jf))
    assert gap_f > 1e-4, gap_f
    assert gap_b * 10 <= gap_f, (gap_b, gap_f)


def test_bf16_rounds_to_nearest_even():
    # 1 + 2^-8 and 1 + 3 2^-8 are ties: to the even 1 and 1 + 2^-6
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20,
                      -(1 + 2 ** -8)], dtype=torch.float32)
    assert cem_mma.bf16(x).tolist() == [1.0, 1 + 2 ** -6, 1 + 2 ** -7, -1.0]
    # nearest-even on the bit pattern, as __float2bfloat16_rn
    r = torch.randn(4096) * 10 ** torch.randint(-6, 6, (4096,)).float()
    bits = r.view(torch.int32)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & -0x10000).view(
        torch.float32)
    assert torch.equal(cem_mma.bf16(r), rounded)


@pytest.mark.parametrize('sd,ad,hid', [(24, 6, 50), (17, 6, 50),
                                       (67, 21, 50), (40, 6, 64)])
def test_bf16_packer_fragment_map(sd, ad, hid):
    """Read the packed buffer back as the m16n8k16 B fragments (lane 4 g
    + t: b0 = rows 2t, 2t + 1 of column g of its tile, b1 = rows 2t + 8,
    2t + 9), and form each layer's A fragments from the previous layer's
    C fragments as the kernel does (n-tiles 2k, 2k + 1 -> k16 tile k):
    the products are the plain ones with no row permutation."""
    g = torch.Generator().manual_seed(sd)
    w1, w2, w3 = (torch.randn(s, generator=g) for s in (
        (sd + ad, hid), (hid, hid), (hid, sd)))
    b1, b2, b3, goal, wv = (torch.randn(n, generator=g) for n in (
        hid, hid, sd, sd, sd))
    lay = cem_mma.layout_bf16(sd, ad, hid)
    packed = cem_mma.pack_weights_bf16(w1, b1, w2, b2, w3, b3, goal, wv)
    assert packed.dtype == BF16 and packed.shape == (1, lay.total)
    assert lay.total % 8 == 0
    p = packed[0].float()

    def unpack(off, kt, nt):
        raw = p[off:off + 128 * kt * nt].reshape(kt, nt, 32, 4)
        W = torch.zeros(16 * kt, 8 * nt)
        for lane in range(32):
            gg, t = divmod(lane, 4)
            for k in range(kt):
                for n in range(nt):
                    for q, d in enumerate((0, 1, 8, 9)):
                        W[16 * k + 2 * t + d, 8 * n + gg] = raw[k, n, lane, q]
        return W

    def padded(w, rows, cols):
        out = torch.zeros(rows, cols)
        out[:w.shape[0], :w.shape[1]] = cem_mma.bf16(w)
        return out
    k_in, k_hid, n_s = 16 * lay.ni, 16 * lay.nh, 8 * lay.nso
    W1 = unpack(lay.l1, lay.ni, 2 * lay.nh)
    W2 = unpack(lay.l2, lay.nh, 2 * lay.nh)
    W3 = unpack(lay.l3, lay.nh, lay.nso)
    assert torch.equal(W1, padded(w1, k_in, k_hid))
    assert torch.equal(W2, padded(w2, k_hid, k_hid))
    assert torch.equal(W3, padded(w3, k_hid, n_s))
    for off, v, n in ((lay.b1, b1, k_hid), (lay.b2, b2, k_hid),
                      (lay.b3, b3, k_in), (lay.goal, goal, k_in),
                      (lay.wvec, wv, k_in)):
        assert torch.equal(p[off:off + n], padded(v[None], 1, n)[0])

    def a_matrix(C):
        """C fragments of a 16-row activation (c0 = (g, 2t), c1 = (g,
        2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1) of each 8-wide
        tile) -> the A matrix the kernel's registers hold: a0 = (c0, c1) of
        tile 2k, a1 = (c2, c3) of tile 2k, a2, a3 the same of tile 2k + 1,
        placed where m16n8k16 reads them (a0: row g, columns 2t, 2t + 1;
        a1: row g + 8; a2: row g, columns 2t + 8, 2t + 9; a3: row g + 8)."""
        A = torch.zeros_like(C)
        for lane in range(32):
            gg, t = divmod(lane, 4)
            for k in range(C.shape[1] // 16):
                for row, col in ((gg, 0), (gg + 8, 0), (gg, 8), (gg + 8, 8)):
                    tile = 2 * k + col // 8
                    for e in range(2):
                        A[row, 16 * k + col + 2 * t + e] = C[
                            row, 8 * tile + 2 * t + e]
        return A
    x = cem_mma.bf16(torch.randn(16, k_in, generator=g))
    assert torch.equal(a_matrix(x), x)
    h = cem_mma.bf16(torch.relu(a_matrix(x) @ W1))
    assert torch.equal(a_matrix(h), h)
    assert torch.allclose(a_matrix(h) @ W2, h @ padded(w2, k_hid, k_hid))


@pytest.mark.parametrize('normalized', [False, True])
@pytest.mark.parametrize('alpha_action', [0.25, 0.3])
def test_rollout_costs_bf16_match_jax(normalized, alpha_action):
    params, norm, s0, acts, goal, w = _inputs(int(normalized), normalized)
    jb = _jax_costs_t(params, norm, s0, acts, goal, w, alpha_action,
                      jnp.bfloat16)
    jf = _jax_costs_t(params, norm, s0, acts, goal, w, alpha_action, None)
    tnorm = None if norm is None else convert.normalizers(JNorm(**norm))
    ours = cem_rollout.mlp_rollout_costs_t(
        convert.mlp_params(params), torch.as_tensor(s0.T.copy()),
        torch.as_tensor(acts.transpose(0, 2, 1).copy()),
        torch.as_tensor(goal), torch.as_tensor(w), tnorm,
        alpha_action=alpha_action, compute_dtype=BF16)
    assert ours.dtype == torch.float32 and ours.shape == (N,)
    _held(ours.numpy(), jb, jf)


def _proposal(rng, B, Hh, ad=AD):
    mean = np.clip(0.3 * rng.normal(size=(B, Hh, ad)), -0.9, 0.9)
    std = 0.2 + rng.uniform(size=(B, Hh, ad))
    return (torch.as_tensor(mean.astype(np.float32)),
            torch.as_tensor(std.astype(np.float32)))


@pytest.mark.parametrize('sampler', ['normal', 'triangular', 'spline4'])
def test_sampler_bf16_costs_of_its_actions_match_jax(sampler):
    rng = np.random.RandomState(7)
    params, norm, _, _, goal, w = _inputs(2, True)
    B, K = 4, 64
    s0 = (norm['state_mean'] + norm['state_std'] * rng.normal(
        size=(B, SD))).astype(np.float32)
    mean, std = _proposal(rng, B, H)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        convert.mlp_params(params), 11, torch.as_tensor(s0), mean, std,
        torch.as_tensor(goal), torch.as_tensor(w), K,
        normalizers=convert.normalizers(JNorm(**norm)), sampler=sampler,
        compute_dtype=BF16)
    assert acts.dtype == BF16 and acts.shape == (B, H, AD, K)
    assert costs.dtype == torch.float32 and costs.shape == (B, K)
    a = acts.float()
    assert float(a.abs().max()) <= 1.0
    flat = a.permute(1, 0, 3, 2).reshape(H, B * K, AD).numpy()
    s0f = np.repeat(s0, K, axis=0)
    jb = _jax_costs_t(params, norm, s0f, flat, goal, w, 0.25, jnp.bfloat16)
    jf = _jax_costs_t(params, norm, s0f, flat, goal, w, 0.25, None)
    _held(costs.reshape(-1).numpy(), jb, jf)


def test_ensemble_sampler_bf16_costs_of_its_actions_match_jax():
    n, B, K = 5, 3, 40
    rng = np.random.RandomState(9)
    ens = JEns(JMLP(SD, AD, HID), n)
    params = jax.tree_util.tree_map(np.asarray,
                                    ens.init(jax.random.PRNGKey(4)))
    norm = _norm(rng)
    s0 = (norm['state_mean'] + norm['state_std'] * rng.normal(
        size=(B, SD))).astype(np.float32)
    goal = rng.normal(size=SD).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=SD).astype(np.float32)
    mean, std = _proposal(rng, B, H)
    costs, acts = cem_rollout.mlp_sample_rollout_costs_ensemble(
        convert.ensemble_params(params), 5, torch.as_tensor(s0), mean, std,
        torch.as_tensor(goal), torch.as_tensor(w), K, n,
        normalizers=convert.normalizers(JNorm(**norm)), compute_dtype=BF16)
    assert acts.dtype == BF16 and acts.shape == (B, H, AD, K)
    flat = acts.float().permute(1, 0, 3, 2).reshape(H, B * K, AD).numpy()
    s0f = np.repeat(s0, K, axis=0)
    member = np.arange(B * K) % K % n

    def jax_by_member(dtype):
        per = [_jax_costs_t(jax.tree_util.tree_map(lambda v: v[m], params),
                            norm, s0f, flat, goal, w, 0.25, dtype)
               for m in range(n)]
        return np.stack(per)[member, np.arange(B * K)]
    _held(costs.reshape(-1).numpy(), jax_by_member(jnp.bfloat16),
          jax_by_member(None))


def test_bf16_refused_past_the_kernel_tiles_and_other_dtypes():
    params = MLPDynamics(SD, AD, hidden_units=HID).init(
        torch.Generator().manual_seed(0), device='cpu')
    with pytest.raises(ValueError, match='hidden <= 128'):
        cem_mma.check_shapes('x', 120, 20, 50, bf16=True)
    with pytest.raises(NotImplementedError, match='compute_dtype'):
        cem_rollout.mlp_sample_rollout_costs(
            params, 0, torch.zeros((1, SD)), torch.zeros((1, 3, AD)),
            torch.ones((1, 3, AD)), torch.zeros(SD), torch.ones(SD), 8,
            compute_dtype=torch.float16)


def test_agent_collect_with_bf16_kernel_kwargs():
    """One GoalStateAgent collection on the walker through the batched CEM
    with the sampler in bf16 (the plain bf16 version on the CPU): the
    planner's refit takes the bf16 actions."""
    env = envs.load('walker', 'walk', device='cpu')
    B, T, K = 3, 2, 20
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner,
        model=MLPDynamics(env.state_dim, env.action_dim, hidden_units=HID),
        horizon=4, optimizer=Mt.adam(0.01), rollout_length=T,
        num_rollouts_per_iteration=B, num_train_iterations=1, writer=None,
        base_path='', seed=0,
        planner_kwargs=dict(num_candidates=K, num_elites=4,
                            num_iterations=2),
        kernel_kwargs={'compute_dtype': BF16})
    goal = env.set_goal(torch.Generator().manual_seed(3))
    calls = []
    real = agents.mpc.mlp_sample_rollout_costs

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw['compute_dtype'], out[1].dtype))
        return out
    agents.mpc.mlp_sample_rollout_costs = spy
    try:
        rolls = agent._policy_collect(B)(
            agent.params, None, goal, torch.Generator().manual_seed(4))
    finally:
        agents.mpc.mlp_sample_rollout_costs = real
    assert calls and all(c == (BF16, BF16) for c in calls), calls
    assert len(calls) == 2 * T
    assert rolls.actions.shape == (B, T, env.action_dim)
    assert rolls.actions.dtype == torch.float32
    assert bool(torch.isfinite(rolls.states).all())
