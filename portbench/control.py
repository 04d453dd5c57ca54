"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's float32. The
model's matrix products (the sampler's rollouts) run as TF32, the
precision just below float32 with TF32 off; the parts that hold no matrix
product, where TF32 changes nothing, are kept in bfloat16, the precision
below other float32: the CEM refit (its candidates, moments and proposal)
and the physics' state, observation and reward after each step. A run
with it in place has to come out not correct; its readings set each
limit's upper end, with those of the faults in ``faults.py``.

The benchmark's own runs never use it. ``tests/test_portbench_control.py``
does, and a chip run at a cell's size prints the readings of the control,
of the port (``--program port``) or of a fault (``--program <Fault>``),
for each seed, in one process:

    python3 portbench/control.py --workload <name> --seed <n> [<n> ...] \
        --seconds <s> [--program control|port|<Fault> ...]
"""

from __future__ import annotations

import contextlib
import sys

import torch

from reference import planner as ref_planner
from reference import tasks as ref_tasks


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def tf32():
    """TF32 matrix products inside, the float32 default restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _EnvState:
    def __init__(self, physics):
        self.physics = physics


class ControlProgram:
    """The reference planner (draws from a generator on the device seeded
    by each CEM iteration's seed) and the reference physics, at the
    control's precisions, behind the interface ``traffic/mpc.py``
    drives."""

    def __init__(self, cfg, device):
        self.task = ref_tasks.Task(cfg['task'], device, torch.float32)
        self.nu = self.task.model.nu
        self.dev = device

    def reset(self, B, generator):
        phys = self._round(self.task.reset(B, generator))
        return _EnvState(phys), bf16(self.task.observe(phys))

    @staticmethod
    def _round(phys):
        return phys.replace(qpos=bf16(phys.qpos), qvel=bf16(phys.qvel))

    def plan(self, params, obs, seeds, goal, weights, P, record=None,
             rows=None):
        B, ad = obs.shape[0], self.nu
        mean = torch.zeros((B, P['horizon'], ad), device=obs.device)
        std = torch.ones_like(mean)
        with tf32():
            for seed in seeds:
                g = torch.Generator(device=obs.device).manual_seed(int(seed))
                cands = ref_planner.draw_candidates(g, mean, std,
                                                    P['candidates'])
                costs = ref_planner.candidate_costs(params, obs, cands, goal,
                                                    weights)
                if record is not None:
                    record.append((mean[rows], std[rows], costs[rows],
                                   cands[rows]))
                mean, std = (bf16(t) for t in ref_planner.refit(
                    mean, std, costs, bf16(cands), P['elites']))
        return torch.clamp(mean, -1.0, 1.0)[:, 0]

    def step(self, state, actions):
        phys, obs, reward = self.task.step(state.physics, actions)
        return _EnvState(self._round(phys)), bf16(obs), bf16(reward)

    @staticmethod
    def physics(state):
        return state.physics


def readings(workload: str, seed: int, seconds: float, device,
             overrides=None, program='control'):
    """The checks of one run with ``program`` in the port's place: the
    control, the port itself (``'port'``) or a fault of ``faults.py``."""
    import faults
    import harness
    import run
    wl = harness.load_json('workloads', workload)
    cfg = harness.load_json('configs', wl['config'])
    args = run.parse_args(['--workload', workload, '--seed', str(seed),
                           '--seconds', str(seconds), '--trace', '0'])
    prog = (ControlProgram(cfg, device) if program == 'control' else None
            if program == 'port' else getattr(faults, program)(cfg, device))
    _, checks = run.run(args, device, overrides=overrides, program=prog)
    return checks


if __name__ == '__main__':
    import argparse
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=5.0)
    p.add_argument('--program', nargs='+', default=['control'])
    a = p.parse_args()
    import run
    run.cache_dirs()
    for prog in a.program:
        for s in a.seed:
            for name, value, limit in readings(
                    a.workload, s, a.seconds, torch.device('cuda', 0),
                    program=prog):
                print(f'{prog} {a.workload} seed {s} {name} {value!r} '
                      f'limit {limit!r}', flush=True)
