"""Faults planted in the timed path, each a version of the port's control
step (``traffic/mpc.Program``) broken underneath. A run with any of them
in the port's place has to come out not correct: the CPU tests run each
at a tiny size (``tests/test_portbench_cells.py``), and
``control.py --program <Fault>`` reads them at a cell's own size on the
card, where they set the upper readings of the draw checks' limits."""

from __future__ import annotations

import torch

from traffic import mpc


class Unchanged(mpc.Program):
    """A step that returns its state unchanged."""

    def step(self, state, actions):
        _, obs, reward = super().step(state, actions)
        return state, obs, reward


class HalfBatch(mpc.Program):
    """Half of the envs left out of the step: they keep their state."""

    def step(self, state, actions):
        new, obs, reward = super().step(state, actions)
        from mujoco_mbrl_tpu_torch.suite.control import _select
        keep = torch.arange(actions.shape[0],
                            device=actions.device) < actions.shape[0] // 2
        return _select(keep, new, state), obs, reward


class AlteredCost(mpc.Program):
    """One candidate's cost altered where the sampler produces it."""

    def sample(self, *a, **k):
        costs, cands = super().sample(*a, **k)
        costs = costs.clone()
        costs[:, 0] *= 1.01
        return costs, cands


class AlteredAction(mpc.Program):
    """The planned action altered where the planner produces it."""

    def plan(self, *a, **k):
        return super().plan(*a, **k) + 0.05


class MeanOnly(mpc.Program):
    """A sampler that returns K copies of the proposal mean (the kernel
    given a zero std), each costed as it is."""

    def sample(self, params, seed, obs, mean, std, goal, weights, P):
        return super().sample(params, seed, obs, mean, torch.zeros_like(std),
                              goal, weights, P)


class StdIgnored(mpc.Program):
    """A sampler that ignores the proposal std (the kernel given ones)."""

    def sample(self, params, seed, obs, mean, std, goal, weights, P):
        return super().sample(params, seed, obs, mean, torch.ones_like(std),
                              goal, weights, P)


class _GivenNoise(mpc.Program):
    """The port's plain sampler on noise ``z`` that the fault shapes."""

    antithetic = True

    def noise(self, g, B, H, ad, K, sampler, dtype):
        """(B, H, ad, Kz) noise, Kz = ceil(K / 2) when antithetic else K."""
        raise NotImplementedError

    def sample(self, params, seed, obs, mean, std, goal, weights, P):
        from mujoco_mbrl_tpu_torch.ops import cem_rollout
        B, H, ad = mean.shape
        K = P['candidates']
        g = torch.Generator(device=obs.device).manual_seed(int(seed))
        z = self.noise(g, B, H, ad, K, P['sampler'], obs.dtype)
        return cem_rollout.mlp_sample_rollout_costs_plain(
            params, seed, obs, mean, std, goal, weights, num_candidates=K,
            antithetic=self.antithetic, sampler=P['sampler'], z=z)


class EnvsShareNoise(_GivenNoise):
    """One noise draw reused by every env."""

    def noise(self, g, B, H, ad, K, sampler, dtype):
        from mujoco_mbrl_tpu_torch.ops import cem_rollout
        z = cem_rollout.draw_noise(g, (1, H, ad, (K + 1) // 2), sampler,
                                   dtype)
        return z.expand(B, H, ad, (K + 1) // 2)


class CandidatesShareNoise(_GivenNoise):
    """One noise draw reused by every candidate of an env."""

    def noise(self, g, B, H, ad, K, sampler, dtype):
        from mujoco_mbrl_tpu_torch.ops import cem_rollout
        z = cem_rollout.draw_noise(g, (B, H, ad, 1), sampler, dtype)
        return z.expand(B, H, ad, (K + 1) // 2)


class NoMirror(_GivenNoise):
    """Every candidate its own draw: candidate k + K/2 no mirror of k."""

    antithetic = False

    def noise(self, g, B, H, ad, K, sampler, dtype):
        from mujoco_mbrl_tpu_torch.ops import cem_rollout
        return cem_rollout.draw_noise(g, (B, H, ad, K), sampler, dtype)


# the faults that break the step or the plan, and those that break the
# sampler's draws (read by draw_gap, noise_z and noise_repeat)
STEP_FAULTS = [Unchanged, HalfBatch, AlteredCost, AlteredAction]
DRAW_FAULTS = [MeanOnly, StdIgnored, EnvsShareNoise, CandidatesShareNoise,
               NoMirror]
