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
   (rtol 1e-4), and checks the action range, the antithetic identity and
   the moments of the sampled noise;
4. drives the main path, ``mujoco_mbrl_tpu_torch.bench.build_bench(
   'walker_walk', 1024, 1000, 30, 3, steps)``, with every launch count
   set to 0 just before and read just after, and checks the physics of
   the last control step against the plain (CPU) step, then profiles
   the main path's device time by kernel (torch.profiler);
5. prints one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the process exits non-zero. It also exits
non-zero without a result when no CUDA card is present or when the
package is missing. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
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


def sampler_phase(dev, torch, params, obs):
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd = obs.shape[1]
    ad = 6
    goal = torch.zeros(sd, device=dev)
    goal[1] = 1.0
    weights = torch.ones(sd, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    mean = (0.3 * torch.randn((B, H, ad), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    worst = 0.0
    for sampler in ('triangular', 'normal'):
        costs, acts = C.mlp_sample_rollout_costs(
            params, 1234, obs, mean, std, goal, weights, K, sampler=sampler)
        ref = C.rollout_costs_of_actions(params, obs, acts, goal, weights)
        torch.cuda.synchronize()
        check(costs.shape == (B, K) and acts.shape == (B, H, ad, K),
              (costs.shape, acts.shape))
        check(bool(torch.isfinite(costs).all()), 'non-finite costs')
        torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
        err = float((costs - ref).abs().max())
        worst = max(worst, err)
        check(float(acts.abs().max()) <= 1.0, 'action out of [-1, 1]')
        a1, a2 = acts[..., :K // 2], acts[..., K // 2:]
        free = (a1.abs() < 1.0) & (a2.abs() < 1.0)
        pair = (a1 + a2 - 2.0 * mean[..., None]).abs()[free]
        check(float(pair.max()) < 1e-5, float(pair.max()))
        # noise moments from an unclipped proposal (std 0.1 around 0)
        _, a_m = C.mlp_sample_rollout_costs(
            params, 99, obs, torch.zeros_like(mean),
            torch.full_like(std, 0.1), goal, weights, K, sampler=sampler)
        z = a_m[..., :K // 2] / 0.1
        zm, zv = float(z.mean()), float(z.var())
        check(abs(zm) < 1e-2 and abs(zv - 1.0) < 2e-2, (zm, zv))
        print(f'sampler {sampler}: max|cost - plain(actions)| = {err:.3e} '
              f'(max |cost| {float(costs.abs().max()):.3f}); '
              f'antithetic max dev {float(pair.max()):.2e}; '
              f'z mean {zm:+.2e} var {zv:.4f}')

    in_dim, hid = sd + ad, params['l2']['w'].shape[0]
    flops = 2.0 * B * K * H * (in_dim * hid + hid * hid + hid * sd)
    n_bytes = 4.0 * (B * H * ad * K + B * K + B * sd + 2 * B * H * ad
                     + in_dim * hid + hid * hid + hid * sd + 2 * hid + 3 * sd)
    bms, by = bound_ms(n_bytes, flops)
    run_k = lambda: C.mlp_sample_rollout_costs(
        params, 7, obs, mean, std, goal, weights, K, sampler='triangular')
    run_p = lambda: C.mlp_sample_rollout_costs_plain(
        params, 7, obs, mean, std, goal, weights, K, sampler='triangular')
    k_ms = time_ms(run_k, 5)
    p_ms = time_ms(run_p, 2)
    print(f'sampler B={B} K={K} H={H}: kernel {k_ms:.3f} ms, plain '
          f'{p_ms:.3f} ms (reference only), bound {bms:.3f} ms ({by}), '
          f'{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved')
    return worst, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by)


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

    # ---- the main path --------------------------------------------------
    warm_state, _ = run(params, state0, gen)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    profile = {}
    t0 = time.perf_counter()
    state, rewards = run(params, warm_state, gen, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    check(counts['cem_sample_rollout'] == ITERS * STEPS, counts)
    check(counts['apgd_solve'] == 10 * STEPS, counts)
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

    kernels = [
        dict(name='apgd_iterate_batched', route='cuda',
             source='mujoco_mbrl_tpu_torch/csrc/apgd_solve.cu',
             replaces='mujoco_mbrl_tpu/ops/apgd_solve.py:60',
             launches=counts['apgd_solve'], max_abs_err=apgd_err,
             library_ms=None, **apgd_t['contact-warm'],
             rounding_decided_envs=rounding_envs,
             cases=apgd_t),
        dict(name='mlp_sample_rollout_costs', route='cuda',
             source='mujoco_mbrl_tpu_torch/csrc/cem_sample_rollout.cu',
             replaces='mujoco_mbrl_tpu/ops/cem_rollout.py:364',
             launches=counts['cem_sample_rollout'], max_abs_err=samp_err,
             ms=samp_t['ms'], plain_ms=samp_t['plain_ms'],
             bound_ms=samp_t['bound_ms'], bound_by=samp_t['bound_by'],
             library_ms=None),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
