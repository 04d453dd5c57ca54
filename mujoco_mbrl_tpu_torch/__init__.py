"""PyTorch / CUDA port of mujoco_mbrl_tpu for NVIDIA Hopper (H100).

The JAX package ``mujoco_mbrl_tpu`` stays the reference; this package
re-implements the walker_walk MPC control step (batched CEM over an MLP
dynamics model, then one batched physics step) with plain PyTorch around
two hand-written CUDA kernels (``csrc/``):

* ``ops.apgd_solve`` — the batched APGD constraint solve;
* ``ops.cem_rollout`` — the fused CEM sample + MLP rollout + cost.

Layout follows the JAX package (``physics/``, ``suite/``, ``models/``,
``planners/``, ``ops/``); the env batch is an explicit leading dimension
where JAX used ``vmap``. Entry points run on ``cuda`` unless the caller
passes ``device='cpu'``; asking for CUDA without a card raises.

This package never imports ``jax`` or ``mujoco_mbrl_tpu``.
"""

from .device import resolve_device

__all__ = ['resolve_device']
