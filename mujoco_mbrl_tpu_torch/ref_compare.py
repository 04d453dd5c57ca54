"""Learning curve of the port's GoalStateAgent against the JAX package's.

The port's counterpart of the "ours" half of ``scripts/ref_compare.py``:
``GoalStateAgent`` with ``RandomShootingPlanner`` and ``MLPDynamics``
(sized by the goal's plan space) on the same shrunk configuration, one run
per seed, and the same metrics: per iteration the policy rollouts' mean
reward (``AvgRolloutRewards/policy``) and total goal cost
(``AvgRolloutTotalCosts/policy``). The curves are compared with the JAX
package's runs recorded in a ``scripts/ref_compare.py`` result (its
"ours" runs) by that script's rule: for the final and the best reward and
cost across seeds, Welch's t = |mean_port - mean_jax| / sqrt(s_p^2 / n_p +
s_j^2 / n_j) with sample stds; the curves agree within seed variance when
every t < 3.

    python -m mujoco_mbrl_tpu_torch.ref_compare \\
        --against benchmarks/ref_compare_walker_walk.json \\
        --out ref_compare_walker_walk_port.json

The configuration defaults to the one the ``--against`` file records
(walker_walk: 5 iterations, rollouts of 40, 3 per iteration, 5 initial,
horizon 10, 200 candidates, 5 seeds). Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

from . import agents, envs, models, planners
from .device import resolve_device
from .models import train as Mt
from .utils import MetricsWriter

_CONFIG_KEYS = ('task', 'iters', 'rollout_len', 'rollouts_per_iter',
                'initial_rollouts', 'horizon', 'candidates', 'seeds')


def run_port(cfg, seed: int, device, out_dir: str) -> dict:
    """One seed's curves: {'rewards', 'costs', 'wall_s'}."""
    import torch

    domain, task_name = cfg['task'].rsplit('_', 1)
    env = envs.load(domain, task_name, device=device)
    plan_dim = int(env.get_goal_weights().shape[0])
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricsWriter(out_dir)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.RandomShootingPlanner,
        model=models.MLPDynamics(plan_dim, env.action_dim),
        horizon=cfg['horizon'], optimizer=Mt.adam(0.01),
        rollout_length=cfg['rollout_len'],
        num_rollouts_per_iteration=cfg['rollouts_per_iter'],
        num_train_iterations=cfg['iters'], writer=writer,
        base_path=out_dir, seed=seed,
        num_initial_rollouts=cfg['initial_rollouts'],
        planner_kwargs=dict(num_trajectories=cfg['candidates']))
    t0 = time.perf_counter()
    agent.train()
    if device.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    writer.close()
    with open(os.path.join(out_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]

    def series(tag):
        sel = [r for r in rows if r.get('tag') == tag]
        return [r['value'] for r in sorted(sel, key=lambda r: r['step'])]
    return {'rewards': series('AvgRolloutRewards/policy'),
            'costs': series('AvgRolloutTotalCosts/policy'),
            'wall_s': round(wall, 1)}


def _mean_std(xs):
    m = sum(xs) / len(xs)
    v = sum((x - m) ** 2 for x in xs) / max(len(xs) - 1, 1)
    return m, math.sqrt(v)


def summary(port_runs, jax_runs) -> dict:
    """scripts/ref_compare.py's statistics, the port against JAX."""
    picks = (('final', 'rewards', lambda r: r['rewards'][-1]),
             ('best', 'rewards', lambda r: max(r['rewards'])),
             ('final_cost', 'costs', lambda r: r['costs'][-1]),
             ('best_cost', 'costs', lambda r: min(r['costs'])))
    out, verdicts = {}, []
    for label, field, pick in picks:
        fp = [pick(r) for r in port_runs if r.get(field)]
        fj = [pick(r) for r in jax_runs if r.get(field)]
        if not fp or not fj:
            continue
        (mp, sp), (mj, sj) = _mean_std(fp), _mean_std(fj)
        se = math.sqrt(sp * sp / len(fp) + sj * sj / len(fj))
        t = abs(mp - mj) / max(se, 1e-9)
        verdicts.append(t < 3.0)
        key = field[:-1]
        out[label] = {f'{key}_port': {'mean': mp, 'std': sp, 'n': len(fp)},
                      f'{key}_jax': {'mean': mj, 'std': sj, 'n': len(fj)},
                      'welch_t': t}
    out['within_seed_variance'] = bool(verdicts) and all(verdicts)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--against', required=True,
                    help='a scripts/ref_compare.py result whose "ours" runs '
                         'are the JAX package\'s')
    ap.add_argument('--out', default=None, help='write the result JSON here')
    ap.add_argument('--device', default='cuda')
    for key in _CONFIG_KEYS:
        ap.add_argument('--' + key.replace('_', '-'), dest=key,
                        type=str if key == 'task' else int, default=None,
                        help='default: the --against file\'s config')
    args = ap.parse_args(argv)
    with open(args.against) as f:
        ref = json.load(f)
    cfg = {k: getattr(args, k) if getattr(args, k) is not None
           else ref['config'][k] for k in _CONFIG_KEYS}
    device = resolve_device(args.device)
    out = {'config': cfg, 'against': args.against, 'device': str(device)}
    if device.type == 'cuda':
        out['card'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix='ref_compare_') as root:
        out['port'] = [run_port(cfg, s, device, os.path.join(root, f'{s}'))
                       for s in range(cfg['seeds'])]
    out['summary'] = summary(out['port'], ref['ours'])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
