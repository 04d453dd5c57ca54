"""PyTorch / CUDA port of mujoco_mbrl_tpu for NVIDIA Hopper (H100).

The JAX package ``mujoco_mbrl_tpu`` stays the reference; this package
re-implements the ported control-suite domains (``suite.all_tasks()``)
and, for walker_walk and cheetah_run, the MPC control step
(batched CEM over the MLP or the ensemble dynamics model, then one batched
physics step), the full MBRL iteration of ``bench.full_loop_bench`` and
the agent loop around it (``experiment`` -> ``agents.GoalStateAgent`` ->
``envs`` collection -> ``data`` replay -> ``models.train`` fitting), with
plain PyTorch around hand-written CUDA kernels (``csrc/``):

* ``ops.apgd_solve.apgd_iterate_batched`` — the batched APGD constraint
  solve up to 96 rows (one warp per env with Ad in registers up to 64
  rows, one block per env with Ad in shared memory past that; box bounds
  shared or per env);
* ``ops.apgd_solve.apgd_iterate_factored`` — the same past 96 rows, over
  the factors J~ and M^-1;
* ``ops.cem_rollout.mlp_sample_rollout_costs`` — the fused CEM sample +
  MLP rollout + cost (normal, triangular and spline4 noise);
* ``ops.cem_rollout.mlp_sample_rollout_costs_ensemble`` — the same over
  an ensemble, candidate k rolled by member k % n (TS-infinity);
* ``ops.cem_rollout.mlp_rollout_costs_t`` — the rollout + cost of given
  candidate actions (cem_batched's non-fused branch), on the samplers'
  tensor-core body.

Layout follows the JAX package (``physics/``, ``suite/``, ``models/``,
``planners/``, ``ops/``, ``envs/``, ``data/``, ``agents/``, ``utils/``);
the env batch is an explicit leading dimension where JAX used ``vmap``.
Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
asking for CUDA without a card raises.

This package never imports ``jax`` or ``mujoco_mbrl_tpu``.
"""

from .device import resolve_device

__all__ = ['resolve_device']
