#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and torch version,
   builds every kernel in mujoco_mbrl_tpu_torch/csrc (nvcc, in parallel);
2. holds the APGD kernel against its plain PyTorch version on synthetic
   problems (non-negative, box, cone and equality rows; cold and warm)
   and on inputs captured from the port's own walker_walk solves at 1024
   envs, at reset and in contact (rtol = atol = 2e-4 on f and v; see
   apgd_phase for the envs whose step size rounding decides);
3. holds the CEM sampler kernel against the plain rollout cost of the
   kernel's own actions at 1024 envs x 1000 candidates x horizon 30
   (rtol 1e-4) for the triangular, normal and spline4 samplers, and checks
   the action range, the antithetic identity, the moments of the sampled
   noise and, for spline4, the lerp-and-renormalise identity between knots
   and the knots' moments;
4. holds the ensemble TS-infinity sampler kernel against the plain cost of
   its own actions by member k % n at walker_ens shapes (1024 envs x 1000
   candidates x horizon 30, 5 members; rtol 1e-4), with the same action
   checks, a small case whose antithetic pairs straddle members, and the
   one-member case against the single-MLP kernel;
5. drives each path with every launch count set to 0 just before and read
   just after:
   a. slice 1's main path, ``bench.build_bench('walker_walk', 1024, 1000,
      30, 3, steps)``, checks the physics of the last control step against
      the plain (CPU) step and profiles the device time by kernel;
   b. the walker_ens control step, the same with ``model_kind='ensemble'``;
   c. the agent loop at full width: GoalStateAgent on walker_walk with a
      5-member ensemble, CEM 1000 x 30 x 3, 1024 seed and 1024 policy
      rollouts (cut to 10 steps), one fit of 5 epochs;
   d. the experiment CLI on the single MLP with the spline4 sampler and 5
      policy rollouts;
6. prints one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the process exits non-zero. It also exits
non-zero without a result when no CUDA card is present or when the
package is missing. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

B, K, H, ITERS, STEPS = 1024, 1000, 30, 3, 3
PEAK_FP32_FLOPS = 67e12      # H100 SXM, non-tensor FP32 (data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 (data sheet)


def check(ok: bool, detail) -> None:
    """Raise when a check fails (also under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {detail}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float):
    t_b, t_o = n_bytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def apgd_phase(dev, torch, walker_cases):
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    g = torch.Generator(device=dev).manual_seed(0)
    nonneg, box, con0, nr = (0, 1, 2), (3,), (5, 8, 11, 14), 17

    def synthetic(Bs):
        G = torch.randn((Bs, nr + 4, nr), generator=g, device=dev)
        Am = torch.einsum('bij,bik->bjk', G, G) / (nr + 4) + 0.05 * torch.eye(
            nr, device=dev)
        s = 1.0 / torch.sqrt(torch.diagonal(Am, dim1=1, dim2=2))
        Ad = (Am * s[:, :, None] * s[:, None, :]).contiguous()
        rhs = torch.randn((Bs, nr), generator=g, device=dev)
        f0 = 0.3 * torch.randn((Bs, nr), generator=g, device=dev)
        v0 = torch.randn((Bs, nr), generator=g, device=dev)
        act = (torch.rand((Bs, nr), generator=g, device=dev) > 0.15).float()
        mu = torch.zeros(nr, device=dev)
        mu[list(con0)] = torch.tensor([0.6, 0.8, 1.0, 0.5], device=dev)
        bnd = torch.zeros(nr, device=dev)
        bnd[list(box)] = 0.7
        return Ad, rhs, f0, v0, act, mu, bnd

    cases = []
    for cold in (True, False):
        for eq in ((), (4,)):
            cases.append(('synthetic', synthetic(B), dict(
                nonneg=nonneg, box_rows=box, con0=con0, iterations=40,
                cold=cold, eq_rows=eq)))
    cases += walker_cases
    worst, rounding_envs = 0.0, 0
    for label, args, kw in cases:
        Bs = args[1].shape[0]
        f_k, v_k = A.apgd_iterate_batched(*args, **kw)
        f_p, v_p, its = A.apgd_iterate_plain(*args, **kw,
                                             return_iterations=True)
        torch.cuda.synchronize()
        # Every env the plain iterate converged in must agree. An env that
        # runs to the iteration cap ends wherever its step size L took it,
        # and L can be decided by rounding: with unit-diagonal (Jacobi)
        # scaling the flat start is an exact eigenvector of a 2-row active
        # block, so the direction the power iteration leaves it in, or a
        # borderline staleness test, depends on summation order (plain
        # float32 vs float64 differ in the same way on the CPU). Such envs
        # may differ, in at most 1% of the batch.
        f_bad = ~torch.isclose(f_k, f_p, rtol=2e-4, atol=2e-4).all(1)
        v_bad = ~torch.isclose(v_k, v_p, rtol=2e-4, atol=2e-4).all(1)
        at_cap = its == kw['iterations']
        check(not bool((f_bad & ~at_cap).any()), (
            label, (f_bad & ~at_cap).nonzero()[:, 0].tolist()))
        odd = f_bad | v_bad
        n_odd = int(odd.sum())
        if n_odd:
            Ad = args[0][odd].double()
            ev = torch.linalg.eigvalsh(Ad)[:, -2:].flip(1)
            rq = lambda v: (v[odd].double() * (Ad @ v[odd].double()[
                ..., None])[..., 0]).sum(1)
            for i, e in enumerate(odd.nonzero()[:, 0].tolist()[:6]):
                print(f'  apgd {label} env {e}: f differs {bool(f_bad[e])}, '
                      f'v differs {bool(v_bad[e])}, {int(its[e])} '
                      f'iterations, {int(args[4][e].sum())} active rows, '
                      f'top eigenvalues {ev[i].tolist()}'
                      f', Rayleigh kernel {float(rq(v_k)[i]):.6f} plain '
                      f'{float(rq(v_p)[i]):.6f}')
        check(n_odd <= Bs // 100, n_odd)
        rounding_envs += n_odd
        err = max(float((f_k - f_p)[~odd].abs().max()),
                  float((v_k - v_p)[~odd].abs().max()))
        worst = max(worst, err)
        print(f'apgd {label} cold={kw["cold"]} eq={kw.get("eq_rows", ())}: '
              f'max|kernel - plain| = {err:.3e} over {Bs - n_odd} of {Bs} '
              f'envs; {int(at_cap.sum())} envs at the iteration cap')

    # times on the walker-captured inputs (cold and warm)
    times = {}
    for label, args, kw in walker_cases:
        tag = label + ('-cold' if kw['cold'] else '-warm')
        Bs, nr_w = args[1].shape
        f_p, v_p, its = A.apgd_iterate_plain(*args, **kw,
                                             return_iterations=True)
        n_mv = (25 if kw['cold'] else 10) + its.double()
        flops = float((2.0 * nr_w * nr_w * n_mv).sum())
        if not kw['cold']:
            flops += 2.0 * Bs * nr_w * nr_w          # row-sum bound
        n_bytes = 4.0 * (Bs * nr_w * nr_w + 6 * Bs * nr_w + 2 * nr_w)
        bms, by = bound_ms(n_bytes, flops)
        k_ms = time_ms(lambda: A.apgd_iterate_batched(*args, **kw), 20)
        p_ms = time_ms(lambda: A.apgd_iterate_plain(*args, **kw), 3)
        times[tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                          mean_iterations=float(its.double().mean()))
        print(f'apgd {tag} B={Bs} nr={nr_w}: kernel {k_ms:.4f} ms, '
              f'plain {p_ms:.3f} ms (reference only), bound {bms:.5f} ms '
              f'({by}), mean APGD iterations '
              f'{times[tag]["mean_iterations"]:.1f}')
    return worst, rounding_envs, times


def capture_walker_solves(dev, torch, env, state, label):
    """Inputs of the port's own walker_walk solves at B envs for one
    control step of zero actions from `state`: the cold first substep
    and the first warm one."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    captured = []
    real = A.apgd_iterate_batched

    def capture(*args, **kw):
        if len(captured) < 2:
            captured.append((label, tuple(a.clone() for a in args),
                             dict(kw)))
        return real(*args, **kw)

    A.apgd_iterate_batched = capture
    try:
        env.step(state, torch.zeros((B, env.model.nu), device=dev))
    finally:
        A.apgd_iterate_batched = real
    torch.cuda.synchronize()
    check([c[2]['cold'] for c in captured] == [True, False], label)
    return captured


def proposal(dev, torch, ad=6):
    """Goal, cost weights and a CEM proposal (mean, std) for B envs."""
    goal = torch.zeros(24, device=dev)
    goal[1] = 1.0
    weights = torch.ones(24, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    mean = (0.3 * torch.randn((B, H, ad), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    return goal, weights, mean, std


def check_actions(torch, label, costs, ref, acts, mean, Kc, skip=None):
    """Costs against the plain cost of the kernel's own actions (rtol
    1e-4; candidates where ``skip`` is set are left out), the action range
    and the antithetic identity; returns the largest cost difference."""
    check(costs.shape == (mean.shape[0], Kc)
          and acts.shape == mean.shape + (Kc,), (costs.shape, acts.shape))
    check(bool(torch.isfinite(costs).all()), f'{label}: non-finite costs')
    if skip is not None:
        costs, ref = costs[~skip], ref[~skip]
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    check(float(acts.abs().max()) <= 1.0, f'{label}: action out of [-1, 1]')
    a1, a2 = acts[..., :Kc // 2], acts[..., Kc // 2:]
    free = (a1.abs() < 1.0) & (a2.abs() < 1.0)
    pair = (a1 + a2 - 2.0 * mean[..., None]).abs()[free]
    check(float(pair.max()) < 1e-5, (label, float(pair.max())))
    return float((costs - ref).abs().max()), float(pair.max())


def noise_moments(torch, label, acts):
    """Moments of z = a / 0.1 from an unclipped proposal (std 0.1 around
    0): mean 0, variance 1."""
    z = acts[..., :acts.shape[-1] // 2] / 0.1
    zm, zv = float(z.mean()), float(z.var())
    check(abs(zm) < 1e-2 and abs(zv - 1.0) < 2e-2, (label, zm, zv))
    return zm, zv


def spline4_identity(torch, acts, mean, std):
    """Where actions are unclipped, z = (a - mean) / std at t = 4i + r
    (r > 0) is ((1 - w) z_4i + w z_4i+4) / sqrt((1 - w)^2 + w^2), w = r/4;
    returns the largest deviation."""
    z = (acts - mean[..., None]) / std[..., None]
    z = torch.where(acts.abs() < 1.0, z, torch.nan)
    worst, horizon = 0.0, acts.shape[1]
    for t in range(horizon):
        i, r = divmod(t, 4)
        if r == 0 or 4 * i + 4 >= horizon:
            continue
        w = r / 4
        lerp = ((1 - w) * z[:, 4 * i] + w * z[:, 4 * i + 4]) / (
            (1 - w) ** 2 + w ** 2) ** 0.5
        worst = max(worst, float((z[:, t] - lerp).abs().nan_to_num(
            0.0).max()))
    check(worst < 1e-4, ('spline4 lerp identity', worst))
    return worst


def sampler_bound(B_, K_, H_, sd, ad, hid, n=1):
    in_dim = sd + ad
    flops = 2.0 * B_ * K_ * H_ * (in_dim * hid + hid * hid + hid * sd)
    n_bytes = 4.0 * (B_ * H_ * ad * K_ + B_ * K_ + B_ * sd + 2 * B_ * H_ * ad
                     + n * (in_dim * hid + hid * hid + hid * sd + 2 * hid
                            + sd) + 2 * sd)
    return flops, bound_ms(n_bytes, flops)


def sampler_phase(dev, torch, params, obs):
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd, ad = obs.shape[1], 6
    goal, weights, mean, std = proposal(dev, torch)
    worst = 0.0
    for sampler in ('triangular', 'normal', 'spline4'):
        costs, acts = C.mlp_sample_rollout_costs(
            params, 1234, obs, mean, std, goal, weights, K, sampler=sampler)
        ref = C.rollout_costs_of_actions(params, obs, acts, goal, weights)
        torch.cuda.synchronize()
        err, pair = check_actions(torch, sampler, costs, ref, acts, mean, K)
        worst = max(worst, err)
        _, a_m = C.mlp_sample_rollout_costs(
            params, 99, obs, torch.zeros_like(mean),
            torch.full_like(std, 0.1), goal, weights, K, sampler=sampler)
        zm, zv = noise_moments(torch, sampler, a_m)
        extra = ''
        if sampler == 'spline4':
            dev_lerp = spline4_identity(torch, acts, mean, std)
            km, kv = noise_moments(torch, 'spline4 knots', a_m[:, 0::4])
            extra = (f'; lerp identity max dev {dev_lerp:.2e}; knots mean '
                     f'{km:+.2e} var {kv:.4f}')
        print(f'sampler {sampler}: max|cost - plain(actions)| = {err:.3e} '
              f'(max |cost| {float(costs.abs().max()):.3f}); '
              f'antithetic max dev {pair:.2e}; '
              f'z mean {zm:+.2e} var {zv:.4f}{extra}')

    hid = params['l2']['w'].shape[0]
    flops, (bms, by) = sampler_bound(B, K, H, sd, ad, hid)
    cases = {}
    for sampler in ('triangular', 'spline4'):
        run_k = lambda: C.mlp_sample_rollout_costs(
            params, 7, obs, mean, std, goal, weights, K, sampler=sampler)
        run_p = lambda: C.mlp_sample_rollout_costs_plain(
            params, 7, obs, mean, std, goal, weights, K, sampler=sampler)
        k_ms = time_ms(run_k, 5)
        p_ms = time_ms(run_p, 2)
        cases[sampler] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                              bound_by=by)
        print(f'sampler {sampler} B={B} K={K} H={H}: kernel {k_ms:.3f} ms, '
              f'plain {p_ms:.3f} ms (reference only), bound {bms:.3f} ms '
              f'({by}), {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved')
    return worst, dict(cases['triangular'], cases=cases)


def ensemble_phase(dev, torch, obs, n=5):
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd, ad, hid = obs.shape[1], 6, 50
    ens = lambda m: models.EnsembleDynamics(
        models.MLPDynamics(sd, ad, hidden_units=hid), m).init(
            torch.Generator().manual_seed(1), device=dev)
    params = ens(n)
    goal, weights, mean, std = proposal(dev, torch)
    worst = 0.0
    for sampler in ('normal', 'triangular'):
        costs, acts = C.mlp_sample_rollout_costs_ensemble(
            params, 1234, obs, mean, std, goal, weights, K, n,
            sampler=sampler)
        ref = C.rollout_costs_of_actions_ensemble(params, obs, acts, goal,
                                                  weights)
        torch.cuda.synchronize()
        err, pair = check_actions(torch, f'ensemble {sampler}', costs, ref,
                                  acts, mean, K)
        worst = max(worst, err)
        _, a_m = C.mlp_sample_rollout_costs_ensemble(
            params, 99, obs, torch.zeros_like(mean),
            torch.full_like(std, 0.1), goal, weights, K, n, sampler=sampler)
        zm, zv = noise_moments(torch, f'ensemble {sampler}', a_m)
        print(f'ensemble {sampler} n={n}: max|cost - plain(actions, member '
              f'k % n)| = {err:.3e} (max |cost| '
              f'{float(costs.abs().max()):.3f}); antithetic max dev '
              f'{pair:.2e}; z mean {zm:+.2e} var {zv:.4f}')

    # K = 60, n = 4: candidate k's antithetic partner k + 30 belongs to
    # member (k + 2) % 4, so pairs straddle members
    p4, Bs = ens(4), 64
    costs, acts = C.mlp_sample_rollout_costs_ensemble(
        p4, 77, obs[:Bs], mean[:Bs], std[:Bs], goal, weights, 60, 4)
    ref = C.rollout_costs_of_actions_ensemble(p4, obs[:Bs], acts, goal,
                                              weights)
    err, pair = check_actions(torch, 'ensemble straddling pairs', costs, ref,
                              acts, mean[:Bs], 60)
    worst = max(worst, err)
    # one member: the single-MLP kernel's actions and costs
    one = {l: {k: v[:1] for k, v in p.items()} for l, p in params.items()}
    mlp = {l: {k: v[0] for k, v in p.items()} for l, p in params.items()}
    c1, a1 = C.mlp_sample_rollout_costs(mlp, 5, obs, mean, std, goal,
                                        weights, K, sampler='normal')
    c2, a2 = C.mlp_sample_rollout_costs_ensemble(one, 5, obs, mean, std,
                                                 goal, weights, K, 1)
    da, dc = float((a1 - a2).abs().max()), float((c1 - c2).abs().max())
    check(da <= 1e-6, ('one-member actions', da))
    torch.testing.assert_close(c2, c1, rtol=1e-5, atol=1e-5)
    print(f'ensemble straddling pairs (B={Bs}, K=60, n=4): max|cost - plain| '
          f'{err:.3e}, antithetic max dev {pair:.2e}; one member vs the MLP '
          f'kernel: max|da| {da:.2e}, max|dcost| {dc:.2e}')

    # walker_ens at 1024 envs (sd 24), and the CLI's --model ens layout:
    # 5 envs, horizon 20, the 20-dim featured state
    p20 = models.EnsembleDynamics(models.MLPDynamics(
        20, ad, hidden_units=hid), n).init(torch.Generator().manual_seed(2),
                                           device=dev)
    cases = {}
    for tag, p, s0, Hc, Bs in (('b1024_h30_sd24', params, obs, H, B),
                               ('b5_h20_sd20', p20, obs[:5, :20], 20, 5)):
        args = (p, 7, s0.contiguous(), mean[:Bs, :Hc].contiguous(),
                std[:Bs, :Hc].contiguous(), goal[:s0.shape[1]],
                weights[:s0.shape[1]], K, n)
        costs, acts = C.mlp_sample_rollout_costs_ensemble(*args)
        ref = C.rollout_costs_of_actions_ensemble(p, args[2], acts, args[5],
                                                  args[6])
        err, _ = check_actions(torch, f'ensemble {tag}', costs, ref, acts,
                               args[3], K)
        worst = max(worst, err)
        flops, (bms, by) = sampler_bound(Bs, K, Hc, s0.shape[1], ad, hid, n)
        k_ms = time_ms(lambda: C.mlp_sample_rollout_costs_ensemble(*args), 5)
        p_ms = time_ms(
            lambda: C.mlp_sample_rollout_costs_ensemble_plain(*args), 2)
        cases[tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                          max_abs_err=err)
        print(f'ensemble sampler {tag} (B={Bs} K={K} H={Hc} n={n}): kernel '
              f'{k_ms:.3f} ms, plain {p_ms:.3f} ms (reference only), bound '
              f'{bms:.4f} ms ({by}), {flops / (k_ms * 1e-3) / 1e12:.2f} '
              f'TFLOP/s achieved')
    main_case = {k: v for k, v in cases['b1024_h30_sd24'].items()
                 if k != 'max_abs_err'}
    return worst, dict(main_case, cases=cases)


def folded_costs64(torch, C, params, norms, fold_dtype, s0, acts, goal,
                   weights, alpha_action):
    """Float64 plain costs of ``acts`` with the normalizers folded into the
    weights in ``fold_dtype`` (float32 is what the kernel and the float32
    plain version are given)."""
    import dataclasses
    p = {l: {k: v.detach().to(fold_dtype) for k, v in d.items()}
         for l, d in params.items()}
    nm = type(norms)(**{f.name: getattr(norms, f.name).to(fold_dtype)
                        for f in dataclasses.fields(norms)})
    w = [t.double() for t in C._fold_normalizers(p, nm)]
    tree = {l: {'w': w[2 * i], 'b': w[2 * i + 1]}
            for i, l in enumerate(('l1', 'l2', 'l3'))}
    f = (C.rollout_costs_of_actions_ensemble if w[0].ndim == 3
         else C.rollout_costs_of_actions)
    return f(tree, s0.double(), acts.double(), goal.double(),
             weights.double(), alpha_action=alpha_action)


def fitted_sampler_check(dev, torch, label, agent, s0, horizon, sampler):
    """The agent's own sampler kernel on its fitted params, with the
    replay's normalizers folded into W1 / W3, at the shapes its loop gives
    it (s0 the 20-dim featured states, padded to 24 lanes in the kernel):
    costs against the plain cost of the kernel's own actions (rtol 1e-4),
    the action checks, and times next to the bound.

    A fitted model rolled past the rollout length it was fitted on can
    amplify float32 rounding, so a few candidates' costs are decided by
    rounding: rounding the folded weights to float32 alone (the fold of
    1 / (std + 1e-6) into W1 cancels in b1) moves their float64 cost by
    more than 1e-5 relative. Those candidates (at most 0.1%) are printed
    and left out of the rtol 1e-4 comparison; every other one must agree.
    """
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    Bs, sd = s0.shape
    ad, hid = agent.environment.action_dim, agent.params['l2']['w'].shape[-1]
    g = torch.Generator(device=dev).manual_seed(11)
    mean = (0.3 * torch.randn((Bs, horizon, ad), generator=g,
                              device=dev)).clamp(-0.9, 0.9)
    std = 0.2 + torch.rand((Bs, horizon, ad), generator=g, device=dev)
    kw = dict(normalizers=agent._normalizers(),
              alpha_action=agent.action_cost_alpha)
    goal, weights = agent.training_goal_state, agent.state_cost_weights
    p = agent.params
    if isinstance(agent.model, models.EnsembleDynamics):
        n = agent.model.n
        run = lambda: C.mlp_sample_rollout_costs_ensemble(
            p, 21, s0, mean, std, goal, weights, K, n, sampler=sampler, **kw)
        run_p = lambda: C.mlp_sample_rollout_costs_ensemble_plain(
            p, 21, s0, mean, std, goal, weights, K, n, sampler=sampler, **kw)
        plain = lambda a: C.rollout_costs_of_actions_ensemble(
            p, s0, a, goal, weights, **kw)
    else:
        n = 1
        run = lambda: C.mlp_sample_rollout_costs(
            p, 21, s0, mean, std, goal, weights, K, sampler=sampler, **kw)
        run_p = lambda: C.mlp_sample_rollout_costs_plain(
            p, 21, s0, mean, std, goal, weights, K, sampler=sampler, **kw)
        plain = lambda a: C.rollout_costs_of_actions(p, s0, a, goal,
                                                     weights, **kw)
    with torch.no_grad():
        costs, acts = run()
        ref = plain(acts)
        c64 = lambda fold_dtype: folded_costs64(
            torch, C, p, kw['normalizers'], fold_dtype, s0, acts, goal,
            weights, kw['alpha_action'])
        r64, r64_w32 = c64(torch.float64), c64(torch.float32)
        torch.cuda.synchronize()
        sens = (r64_w32 - r64).abs() / (r64.abs() + 1e-4)
        decided = sens > 1e-5
        off = ~torch.isclose(costs, ref, rtol=1e-4, atol=1e-4)
        n_dec, n_off = int(decided.sum()), int(off.sum())
        rel = lambda x: float(((x - r64).abs() / (r64.abs() + 1e-4)).max())
        print(f'{label}: {n_dec} of {Bs * K} candidates decided by rounding '
              f'(max sensitivity {float(sens.max()):.2e}); {n_off} beyond '
              f'rtol 1e-4 of the float32 plain; max rel. error vs float64: '
              f'kernel {rel(costs):.2e}, float32 plain {rel(ref):.2e}')
        for b, k in off.nonzero()[:8].tolist():
            print(f'  env {b} candidate {k}: kernel {float(costs[b, k]):.6f} '
                  f'plain {float(ref[b, k]):.6f} float64 '
                  f'{float(r64[b, k]):.6f} sensitivity '
                  f'{float(sens[b, k]):.2e}')
        check(n_dec <= Bs * K // 1000, (label, n_dec))
        err, pair = check_actions(torch, label, costs, ref, acts, mean, K,
                                  skip=decided)
        extra = ''
        if sampler == 'spline4':
            extra = (f'; lerp identity max dev '
                     f'{spline4_identity(torch, acts, mean, std):.2e}')
        k_ms = time_ms(run, 5)
        p_ms = time_ms(run_p, 1)
    flops, (bms, by) = sampler_bound(Bs, K, horizon, sd, ad, hid, n)
    w1 = C._fold_normalizers(p, kw['normalizers'])[0].detach()
    print(f'{label} (fitted params, folded normalizers, max|W1\'| '
          f'{float(w1.abs().max()):.3e}; B={Bs} K={K} H={horizon} sd={sd} '
          f'{sampler}): max|cost - plain(actions)| = {err:.3e} (max |cost| '
          f'{float(costs.abs().max()):.3f}); antithetic max dev {pair:.2e}'
          f'{extra}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (reference '
          f'only), bound {bms:.4f} ms ({by})')
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err, rounding_decided_candidates=n_dec)


def profile_phase(torch, run, params, state, gen, wall_plain):
    """Device time by kernel over the main path's control steps
    (torch.profiler), and the device-busy share of the unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(params, state, gen)
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, 'self_device_time_total',
                                 getattr(e, 'self_cuda_time_total', 0.0))
    events = [e for e in prof.key_averages() if dev_time(e) > 0]
    total_ms = sum(dev_time(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    print(f'profile: {STEPS} control steps, device busy {total_ms:.2f} ms in '
          f'{n_kernels} device ops = '
          f'{100 * total_ms / (1e3 * wall_plain):.1f}% '
          f'of the unprofiled {1e3 * wall_plain:.1f} ms wall')
    for e in sorted(events, key=dev_time, reverse=True)[:12]:
        print(f'  {dev_time(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}')


def ens_control_step_phase(dev, torch):
    """The walker_ens control step: build_bench with the 5-member
    ensemble; 3 ensemble sampler + 10 APGD launches per control step."""
    from mujoco_mbrl_tpu_torch import ops
    from mujoco_mbrl_tpu_torch.bench import build_bench

    run, (params, state0, gen) = build_bench(
        'walker_walk', B, K, H, ITERS, STEPS, device=dev,
        model_kind='ensemble')
    warm_state, _ = run(params, state0, gen)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    profile = {}
    t0 = time.perf_counter()
    state, rewards = run(params, warm_state, gen, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    check(counts == dict(counts, cem_sample_rollout_ens=ITERS * STEPS,
                         apgd_solve=10 * STEPS, cem_sample_rollout=0),
          counts)
    for name, x in (('qpos', state.physics.qpos), ('reward', rewards)):
        check(bool(torch.isfinite(x).all()), name)
    out = dict(ms_per_step=1e3 * wall / STEPS,
               plan_ms=1e3 * profile['plan'] / STEPS,
               physics_ms=1e3 * profile['physics'] / STEPS)
    print(f'walker_ens control step: {STEPS} control steps x {B} envs in '
          f'{wall:.3f} s = {B * STEPS / wall:.1f} env-steps/s, '
          f'{out["ms_per_step"]:.2f} ms per control step (plan '
          f'{out["plan_ms"]:.2f} ms, physics {out["physics_ms"]:.2f} ms); '
          f'launches {counts}')
    return counts, out


AGENT_T, AGENT_EPOCHS, AGENT_BATCH = 10, 5, 512


def agent_phase(dev, torch, tmp):
    """GoalStateAgent.train() on walker_walk at full width: 5-member
    ensemble (hidden 50) over the 20-dim featured state, CEM 1000 x 30 x 3,
    1024 seed + 1024 policy rollouts cut to AGENT_T steps, one fit of
    AGENT_EPOCHS epochs at batch 512, replay capacity 2048 rollouts."""
    from mujoco_mbrl_tpu_torch import agents, data, envs, models, ops
    from mujoco_mbrl_tpu_torch import planners
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.utils import MetricsWriter

    env = envs.load('walker', 'walk', device=dev)
    model = models.EnsembleDynamics(models.MLPDynamics(
        env.state_dim, env.action_dim, hidden_units=50), 5)
    dataset = data.init_replay(2 * B, AGENT_T, env.state_dim,
                               env.observation_dim, env.action_dim,
                               device=dev)
    writer = MetricsWriter(tmp)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=H, optimizer=Mt.adam(0.01), rollout_length=AGENT_T,
        num_rollouts_per_iteration=B, num_train_iterations=1, writer=writer,
        base_path=tmp, dataset=dataset,
        planner_kwargs=dict(num_candidates=K, num_elites=K // 10,
                            num_iterations=ITERS),
        train_epochs=AGENT_EPOCHS, train_batch_size=AGENT_BATCH,
        num_initial_rollouts=B, seed=0)
    phases = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phases.append((name, time.perf_counter() - t0, out))
            return out
        return run

    agent.add_rollouts = timed('collect', agent.add_rollouts)
    agent.fit_model = timed('fit', agent.fit_model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    writer.close()
    check([p[0] for p in phases] == ['collect', 'fit', 'collect'],
          [p[0] for p in phases])
    # 3 CEM iterations per policy step; 10 physics substeps per control
    # step of both collections (the featured-state forward of reset and
    # step stops at the velocity stage: no solve)
    check(counts == dict(counts, cem_sample_rollout_ens=ITERS * AGENT_T,
                         apgd_solve=2 * 10 * AGENT_T, cem_sample_rollout=0),
          counts)
    check(agent.dataset.filled == 2 * B, agent.dataset.filled)
    buf = agent.dataset
    for name in ('states', 'observations', 'actions', 'rewards'):
        check(bool(torch.isfinite(getattr(buf, name)).all()), name)
    losses = phases[1][2].losses
    n_up = losses.shape[0]
    check(n_up == AGENT_EPOCHS * (2 * B * AGENT_T // AGENT_BATCH), n_up)
    check(bool(torch.isfinite(losses).all()), 'non-finite training loss')
    first, last = float(losses[:n_up // 10].mean()), float(
        losses[-(n_up // 10):].mean())
    check(last < first, ('training loss did not decrease', first, last))
    rewards = {}
    with open(os.path.join(tmp, 'metrics.jsonl')) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec['tag'].startswith('AvgRolloutRewards/'):
                rewards[rec['tag'].split('/')[1]] = rec['value']
    times = {'seed_collect_s': phases[0][1], 'fit_s': phases[1][1],
             'policy_collect_s': phases[2][1], 'train_s': wall}
    print(f'agent loop (walker_walk, ensemble n=5, {B} + {B} rollouts of '
          f'{AGENT_T} steps, fit {AGENT_EPOCHS} epochs = {n_up} updates): '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f'; loss {first:.4f} -> {last:.4f}; mean rollout reward '
          f'{rewards}; launches {counts}')
    states = phases[2][2].states[:, -1].contiguous()
    check(states.shape == (B, 20), states.shape)
    fitted = fitted_sampler_check(dev, torch, 'agent ensemble sampler',
                                  agent, states, H, 'normal')
    return counts, times, fitted


def cli_phase(dev, torch, tmp):
    """The port's experiment CLI: single MLP, spline4 sampler, 5 policy
    rollouts of 10 steps (CEM 1000 candidates x 5 iterations)."""
    from mujoco_mbrl_tpu_torch import experiment, ops

    args = experiment.parse_args([
        '--exp_dir', tmp, '--environment', 'walker_walk', '--planner', 'cem',
        '--model', 'nn', '--kernel_kwargs', '{"sampler": "spline4"}',
        '--num_rollouts_per_iteration', '5', '--rollout_length', '10',
        '--num_train_iterations', '1', '--train_epochs', '2'])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent = experiment.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    check(counts['cem_sample_rollout'] == 5 * 10
          and counts['cem_sample_rollout_ens'] == 0, counts)
    check(os.path.exists(os.path.join(tmp, 'agent_final.pt')),
          'agent_final not written')
    print(f'experiment CLI (nn, spline4, 5 rollouts of 10 steps): {wall:.3f} '
          f's; launches {counts}')
    # the 5 policy rollouts follow the 20 seed rollouts in the ring
    buf = agent.dataset
    check(buf.filled == 25 and buf.cursor == 25, (buf.filled, buf.cursor))
    states = buf.states[20:25, -1].contiguous()
    check(states.shape == (5, 20) and agent.horizon == 20,
          (states.shape, agent.horizon))
    fitted = fitted_sampler_check(dev, torch, 'CLI MLP sampler', agent,
                                  states, agent.horizon, 'spline4')
    return counts, fitted


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import mujoco_mbrl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port package is missing ({e})',
              file=sys.stderr)
        return 1
    from mujoco_mbrl_tpu_torch import ops, suite
    from mujoco_mbrl_tpu_torch.bench import build_bench
    from mujoco_mbrl_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}')
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    _build.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'(per source: {_build.BUILD_SECONDS})')
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[{name}] {line.strip()}')

    run, (params, state0, gen) = build_bench('walker_walk', B, K, H, ITERS,
                                             STEPS, device=dev)
    env = suite.load('walker', 'walk', device=dev)
    # solves at the bench's reset states (what the short main path below
    # sees) and after 20 zero-action control steps, fallen and in contact
    # with the floor (what a long episode sees)
    fallen = state0
    for _ in range(20):
        fallen, _ = env.step(fallen, torch.zeros((B, 6), device=dev))
    walker_cases = (capture_walker_solves(dev, torch, env, state0, 'reset')
                    + capture_walker_solves(dev, torch, env, fallen,
                                            'contact'))
    apgd_err, rounding_envs, apgd_t = apgd_phase(dev, torch, walker_cases)
    obs0 = suite.flatten_observation(env._observe(
        env.model, state0.physics, ()))
    samp_err, samp_t = sampler_phase(dev, torch, params, obs0)
    ens_err, ens_t = ensemble_phase(dev, torch, obs0)

    # ---- slice 1's main path: the MPC control step over the MLP ---------
    warm_state, _ = run(params, state0, gen)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    profile = {}
    t0 = time.perf_counter()
    state, rewards = run(params, warm_state, gen, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    check(counts == dict(counts, cem_sample_rollout=ITERS * STEPS,
                         apgd_solve=10 * STEPS, cem_sample_rollout_ens=0),
          counts)
    for name, x in (('qpos', state.physics.qpos), ('qvel', state.physics.qvel),
                    ('reward', rewards)):
        check(bool(torch.isfinite(x).all()), name)
    check(state.physics.qpos.shape == (B, 9), state.physics.qpos.shape)
    print(f'main path: {STEPS} control steps x {B} envs in {wall:.3f} s = '
          f'{B * STEPS / wall:.1f} env-steps/s, {1e3 * wall / STEPS:.2f} ms '
          f'per control step (plan {1e3 * profile["plan"] / STEPS:.2f} ms, '
          f'physics {1e3 * profile["physics"] / STEPS:.2f} ms); launches '
          f'{counts}; mean reward per step {rewards.tolist()}')

    # the last control step's physics against the plain version on the CPU
    env_cpu = suite.load('walker', 'walk', device='cpu')
    g_cpu = torch.Generator().manual_seed(5)
    acts = 2 * torch.rand((B, 6), generator=g_cpu) - 1
    start = warm_state
    to_cpu = lambda s: type(s)(physics=type(s.physics)(
        qpos=s.physics.qpos.cpu(), qvel=s.physics.qvel.cpu(),
        time=s.physics.time.cpu()), params=(), step_count=s.step_count.cpu(),
        last=s.last.cpu())
    s_gpu, ts_gpu = env.step(start, acts.to(dev))
    s_cpu, ts_cpu = env_cpu.step(to_cpu(start), acts)
    dq = float((s_gpu.physics.qpos.cpu() - s_cpu.physics.qpos).abs().max())
    dr = float((ts_gpu.reward.cpu() - ts_cpu.reward).abs().max())
    print(f'physics step, card vs plain CPU at {B} envs: max|dqpos| {dq:.2e}, '
          f'max|dreward| {dr:.2e}')
    check(dq < 1e-3 and dr < 1e-3, (dq, dr))
    profile_phase(torch, run, params, state, gen, wall)

    # ---- slice 3: walker_ens control step, agent loop, CLI -------------
    ens_counts, _ = ens_control_step_phase(dev, torch)
    with tempfile.TemporaryDirectory() as tmp:
        agent_counts, _, agent_fit = agent_phase(dev, torch, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cli_counts, cli_fit = cli_phase(dev, torch, tmp)
    samp_t['cases']['cli_b5_h20_spline4_fitted'] = cli_fit
    ens_t['cases']['agent_b1024_sd20_fitted'] = agent_fit
    samp_err = max(samp_err, cli_fit['max_abs_err'])
    ens_err = max(ens_err, agent_fit['max_abs_err'])

    by_path = lambda key: {
        'control_step': counts[key], 'walker_ens_control_step':
        ens_counts[key], 'agent_loop': agent_counts[key],
        'cli_spline4': cli_counts[key]}
    kernels = [
        dict(name='apgd_iterate_batched', route='cuda',
             source='mujoco_mbrl_tpu_torch/csrc/apgd_solve.cu',
             replaces='mujoco_mbrl_tpu/ops/apgd_solve.py:60',
             launches=counts['apgd_solve'], max_abs_err=apgd_err,
             library_ms=None, **apgd_t['contact-warm'],
             rounding_decided_envs=rounding_envs,
             launches_by_path=by_path('apgd_solve'), cases=apgd_t),
        dict(name='mlp_sample_rollout_costs', route='cuda',
             source='mujoco_mbrl_tpu_torch/csrc/cem_sample_rollout.cu',
             replaces='mujoco_mbrl_tpu/ops/cem_rollout.py:364 '
                      '(_sample_kernel_multi), mujoco_mbrl_tpu/ops/'
                      'cem_rollout.py:258 (_sample_kernel)',
             launches=counts['cem_sample_rollout'], max_abs_err=samp_err,
             library_ms=None, launches_by_path=by_path('cem_sample_rollout'),
             **samp_t),
        dict(name='mlp_sample_rollout_costs_ensemble', route='cuda',
             source='mujoco_mbrl_tpu_torch/csrc/cem_sample_rollout_ens.cu',
             replaces='mujoco_mbrl_tpu/ops/cem_rollout.py:671 '
                      '(_sample_kernel_ens_grouped), mujoco_mbrl_tpu/ops/'
                      'cem_rollout.py:840 (_sample_kernel_ens)',
             launches=agent_counts['cem_sample_rollout_ens'],
             max_abs_err=ens_err, library_ms=None,
             launches_by_path=by_path('cem_sample_rollout_ens'), **ens_t),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
