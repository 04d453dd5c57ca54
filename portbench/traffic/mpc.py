"""Closed-loop MPC control steps on B envs in lockstep.

One unit of work is one control step: one batched CEM plan through the
candidate sampler (``planners.cem_batched`` over
``ops.mlp_sample_rollout_costs``: one sampler launch a CEM iteration),
then one ``env.step`` of the suite task (its physics substeps, each with
its constraint solve). The wiring is a frozen copy of the port's
``bench._planner`` / ``build_bench``. The envs start from the task's reset
drawn from ``--seed``; the model's weights are drawn on the device from
``--seed``; the CEM iterations' seeds come from the same CPU generator as
the reset, one draw a step.

For ``correct`` the cell keeps, for a sample of envs drawn from the seed,
what each plan's sampler read and returned (proposal mean and std, costs,
candidates) and, for every step, references to the envs' state, the
planned actions and what the step returned. After the window the plain
reference (``reference/``) judges them: the sampler's costs of its own
candidates, the candidates against the law of the draws the
configuration states (``reference/draws.py``), each CEM refit, a sample
of the physics steps, and the reset.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

import torch

from counts import mlp as mlp_counts
from reference import draws as ref_draws
from reference import planner as ref_planner
from reference import tasks as ref_tasks

HIDDEN_KEYS = ('l1', 'l2', 'l3')


def make_params(seed: int, sd: int, ad: int, hidden: int, device):
    """MLP weights (LeCun-uniform, fan-in bounds) from one draw on the
    device from ``seed``."""
    shapes = [(sd + ad, hidden), (hidden,), (hidden, hidden), (hidden,),
              (hidden, sd), (sd,)]
    fan_in = [sd + ad, sd + ad, hidden, hidden, hidden, hidden]
    n = sum(torch.Size(s).numel() for s in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=g, device=device) * 2 - 1
    out, i = [], 0
    for shape, fi in zip(shapes, fan_in):
        k = torch.Size(shape).numel()
        out.append((u[i:i + k] / fi ** 0.5).reshape(shape))
        i += k
    return {name: {'w': out[2 * j], 'b': out[2 * j + 1]}
            for j, name in enumerate(HIDDEN_KEYS)}


def as64(params):
    return {k: {kk: vv.detach().double() for kk, vv in v.items()}
            for k, v in params.items()}


def check_envs(seed: int, B: int, n: int, device) -> torch.Tensor:
    """The envs whose planner work is kept for the check, drawn from the
    seed by a generator of its own."""
    g = torch.Generator().manual_seed(seed + 7919)
    return torch.sort(torch.randperm(B, generator=g)[:min(n, B)]).values.to(
        device)


def row_gaps(*pairs) -> torch.Tensor:
    """Each row's largest |prog - ref| / (1 + |ref|) over the pairs
    (prog, ref) of (N, ...) tensors."""
    out = None
    for prog, ref in pairs:
        g = ((prog.double() - ref).abs() / (1 + ref.abs())).reshape(
            prog.shape[0], -1).amax(1)
        out = g if out is None else torch.maximum(out, g)
    return out


def p90(values: torch.Tensor) -> float:
    """The value that 90% of ``values`` lie at or below: of 16 the second
    largest, of 256 the 26th largest."""
    v = torch.sort(values.flatten()).values
    return float(v[max(0, math.ceil(0.9 * v.numel()) - 1)])


class Program:
    """The port's control step: the planner and the env, wired as
    ``bench._planner`` / ``build_bench`` wire them."""

    def __init__(self, cfg, device):
        from mujoco_mbrl_tpu_torch import suite
        self.suite = suite
        domain, task = cfg['task'].rsplit('_', 1)
        self.env = suite.load(domain, task, device=device)
        self.nu = self.env.model.nu

    def reset(self, B: int, generator: torch.Generator):
        state, ts = self.env.reset(B, generator)
        return state, self.suite.flatten_observation(ts.observation)

    def sample(self, params, seed, obs, mean, std, goal, weights, P):
        """One sampler launch: the costs (B, K) and candidates
        (B, H, ad, K) of ``P['candidates']`` draws around mean / std."""
        from mujoco_mbrl_tpu_torch.ops import mlp_sample_rollout_costs
        return mlp_sample_rollout_costs(
            params, seed, obs, mean, std, goal, weights,
            num_candidates=P['candidates'], sampler=P['sampler'])

    def plan(self, params, obs, seeds, goal, weights, P,
             record: Optional[list] = None, rows=None):
        from mujoco_mbrl_tpu_torch.planners import cem_batched

        def scf(seed, mean, std):
            costs, cands = self.sample(params, seed, obs, mean, std, goal,
                                       weights, P)
            if record is not None:
                record.append((mean[rows], std[rows], costs[rows],
                               cands[rows]))
            return costs, cands
        traj = cem_batched(seeds, obs, horizon=P['horizon'],
                           action_dim=self.nu,
                           num_candidates=P['candidates'],
                           num_elites=P['elites'], sample_costs_fn=scf)
        return traj.actions[0]

    def step(self, state, actions):
        state, ts = self.env.step(state, actions)
        return state, self.suite.flatten_observation(ts.observation), \
            ts.reward

    @staticmethod
    def physics(state):
        return state.physics


class Cell:
    """Set-up, one control step a unit, and the check after the window."""

    def __init__(self, cfg, wl, seed: int, device, tracer,
                 program=None):
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, device
        self.tracer = tracer
        self.P = dict(cfg['planner'])
        self.B = int(wl['envs'])
        self.prog = program or Program(cfg, device)
        self.gen = torch.Generator().manual_seed(seed)
        self.state, self.obs = self.prog.reset(self.B, self.gen)
        self.phys0, self.obs0 = self.prog.physics(self.state), self.obs
        self.sd, self.ad = self.obs.shape[1], self.prog.nu
        hidden = cfg['model']['hidden']
        self.params = make_params(seed, self.sd, self.ad, hidden, device)
        self.goal = torch.zeros(self.sd, device=device)
        self.goal[cfg['goal_index']] = 1.0
        self.weights = torch.ones(self.sd, device=device)
        self.rows = check_envs(seed, self.B, wl['check']['envs'], device)
        self.units_per_step = self.B
        self.model_flops = mlp_counts.plan_flops(
            self.B, self.P['candidates'], self.P['horizon'],
            self.P['cem_iters'], self.sd, self.ad, hidden)
        self.log: List[Dict] = []
        self.recording = False
        # warm-up: one control step builds and loads every kernel and
        # warms the allocator at the window's shapes; it is not judged
        self.step()
        self.recording = True

    def step(self):
        seeds = torch.randint(0, 2 ** 31 - 1, (self.P['cem_iters'],),
                              generator=self.gen).tolist()
        record = [] if self.recording else None
        with self.tracer.span('plan'):
            actions = self.prog.plan(self.params, self.obs, seeds, self.goal,
                                     self.weights, self.P, record=record,
                                     rows=self.rows)
        state_in, obs_in = self.state, self.obs
        with self.tracer.span('physics'):
            self.state, self.obs, reward = self.prog.step(self.state,
                                                          actions)
        if self.recording:
            self.log.append(dict(state_in=self.prog.physics(state_in),
                                 obs_in=obs_in, actions=actions,
                                 record=record,
                                 state_out=self.prog.physics(self.state),
                                 obs_out=self.obs, reward=reward))

    def release(self):
        """Drop what the program holds beyond what the check reads."""
        self.state = self.obs = None
        self.prog = None

    # ---- the check ---------------------------------------------------
    def check(self) -> List[tuple]:
        """(name, reading, limit) of each number compared."""
        lim = self.wl['limits']
        cost, refit, draw_gap, noise_z, noise_repeat = self.planner_gaps()
        phys = self.physics_gap()
        return [('cost_gap', cost, lim['cost_gap']),
                ('refit_gap', refit, lim['refit_gap']),
                ('draw_gap', draw_gap, lim['draw_gap']),
                ('noise_z', noise_z, lim['noise_z']),
                ('noise_repeat', noise_repeat, lim['noise_repeat']),
                ('physics_gap', phys, lim['physics_gap'])]

    def planner_gaps(self):
        """The sampler's costs of its own candidates against the plain
        rollout cost (largest relative gap); each CEM refit against the
        plain refit of the same candidates and costs (largest absolute gap
        of the next proposal mean and std, and of the planned action); and
        the candidates against the law of the draws (``DrawStats``)."""
        rows, params64 = self.rows, as64(self.params)
        goal, w = self.goal.double(), self.weights.double()
        cost_gap = refit_gap = 0.0
        draws = ref_draws.DrawStats()
        for entry in self.log:
            s0 = entry['obs_in'][rows].double()
            rec = entry['record']
            for j, (mean, std, costs, cands) in enumerate(rec):
                draws.add(mean, std, cands)
                cands64 = cands.double()
                ref = ref_planner.candidate_costs(params64, s0, cands64,
                                                  goal, w)
                cost_gap = max(cost_gap, float(
                    ((costs.double() - ref).abs() / ref.abs()).max()))
                m, s = ref_planner.refit(mean.double(), std.double(),
                                         costs.double(), cands64,
                                         self.P['elites'])
                if j + 1 < len(rec):
                    nm, ns = rec[j + 1][0], rec[j + 1][1]
                    gap = max(float((nm.double() - m).abs().max()),
                              float((ns.double() - s).abs().max()))
                else:
                    act = torch.clamp(m, -1.0, 1.0)[:, 0]
                    gap = float((entry['actions'][rows].double()
                                 - act).abs().max())
                refit_gap = max(refit_gap, gap)
        return (cost_gap, refit_gap) + draws.readings()

    def physics_steps(self, n_steps: int) -> List[int]:
        """The window's steps whose physics the reference repeats, drawn
        from the seed."""
        k = min(self.wl['check']['physics_steps'], n_steps)
        return sorted(random.Random(self.seed).sample(range(n_steps), k))

    def physics_rows(self, steps: List[int]):
        """Each checked env's gap at the reset, against the reference's
        reset from the same seed, and at each of ``steps`` (the window's
        steps), against one reference step from the program's state with
        the program's actions: (E,) and (len(steps) * E,) row gaps over
        qpos, qvel, observation and reward."""
        rows = self.rows
        task = ref_tasks.Task(self.cfg['task'], self.dev, torch.float64)
        ref0 = task.reset(self.B, torch.Generator().manual_seed(self.seed),
                          rows=rows.cpu())
        p0 = self.phys0
        reset = row_gaps((p0.qpos[rows], ref0.qpos),
                         (p0.qvel[rows], ref0.qvel),
                         (self.obs0[rows], task.observe(ref0)))
        picked = [self.log[i] for i in steps]
        if not picked:
            return reset, reset[:0]
        cat = lambda f: torch.cat([f(e)[rows] for e in picked]).double()
        s_in = task.state(cat(lambda e: e['state_in'].qpos),
                          cat(lambda e: e['state_in'].qvel),
                          cat(lambda e: e['state_in'].time))
        s_out, obs, rew = task.step(s_in, cat(lambda e: e['actions']))
        return reset, row_gaps(
            (cat(lambda e: e['state_out'].qpos), s_out.qpos),
            (cat(lambda e: e['state_out'].qvel), s_out.qvel),
            (cat(lambda e: e['obs_out']), obs),
            (cat(lambda e: e['reward'])[:, None], rew[:, None]))

    def physics_gap(self) -> float:
        """The 90th percentile of the checked envs' gaps at the reset, and
        of their gaps at the sampled steps; the larger. A percentile, not
        the largest: an env in contact whose solve a rounding decides (a
        contact made or not, the iteration cap) reads apart from the
        reference by the solver's tolerance, not by rounding, in a few
        env-steps a run."""
        reset, stepped = self.physics_rows(self.physics_steps(len(self.log)))
        return max(p90(reset), p90(stepped) if stepped.numel() else 0.0)
