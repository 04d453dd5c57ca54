"""RL environment core over a batch of envs (dm_env TimeStep protocol).

Port of mujoco_mbrl_tpu/suite/control.py: ``Environment.reset``,
``_observe``, ``step`` and ``step_with_data`` (with a task's early
termination), ``autoreset_step``, ``observation_spec`` and ``render``
(an MJCF camera, with the reward tint of ``visualize_reward``), plus
``flatten_observation`` and ``action_spec``. The JAX environment is one
env under ``vmap``; here every method takes and returns the env batch as
the leading dimension. A task's per-episode params (reacher's target,
point_mass:hard's tendon directions, finger:turn's target site,
quadruped:escape's terrain) reach the physics through ``_model_with``,
which applies the task's ``apply_params`` to the shared model as per-env
fields (``physics.model.with_env_fields``). Stateful actuators'
activations (``State.act``) travel with the physics state through reset,
step and autoreset. ``max_reset_attempts`` N > 1 redraws an env's
episode init where it diverged, up to N draws in all (JAX's bad-init
retry, composer/environment.py:308-318).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..physics import engine
from ..physics import model as M

FIRST, MID, LAST = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TimeStep:
    step_type: torch.Tensor   # (B,) int32: FIRST/MID/LAST
    reward: torch.Tensor      # (B,)
    discount: torch.Tensor    # (B,)
    observation: Dict[str, torch.Tensor]

    def first(self) -> torch.Tensor:
        return self.step_type == FIRST

    def last(self) -> torch.Tensor:
        return self.step_type == LAST


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Carried env state: physics + task params + bookkeeping, batched."""
    physics: M.State
    params: Any
    step_count: torch.Tensor   # (B,) int32 control steps this episode
    last: torch.Tensor         # (B,) bool: previous step returned LAST


class ArraySpec:
    def __init__(self, shape, dtype, name=''):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.name = name


class BoundedArraySpec:
    def __init__(self, shape, dtype, minimum, maximum, name=''):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.minimum = np.broadcast_to(np.asarray(minimum), shape)
        self.maximum = np.broadcast_to(np.asarray(maximum), shape)
        self.name = name


def action_spec(model: M.Model) -> BoundedArraySpec:
    """Action spec from actuator ctrlrange."""
    lo = np.full(model.nu, -np.inf)
    hi = np.full(model.nu, np.inf)
    cr = model.actuator_ctrlrange.cpu().numpy()
    for u in range(model.nu):
        if model.actuator_ctrllimited[u]:
            lo[u], hi[u] = cr[u, 0], cr[u, 1]
    return BoundedArraySpec((model.nu,), np.float32, lo, hi, 'action')


def flatten_observation(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate a batched observation dict into (B, obs_dim)."""
    parts = [v.reshape(v.shape[0], -1) for v in obs.values()]
    return torch.cat(parts, dim=1)


def _select(mask: torch.Tensor, a, b):
    """`a` where the env's `mask` (B,) is set, else `b`, leaf by leaf over
    dataclasses, dicts, tuples and tensors (JAX's tree_map of where). A
    leaf of fewer dims broadcasts over the other's trailing ones, as JAX's
    per-env ``where`` takes a reset's scalar reward against a stepped
    reward vector (soccer's (2n,) per-player rewards)."""
    if isinstance(a, torch.Tensor):
        nd = max(a.dim(), b.dim())
        pad = lambda x: x.reshape(tuple(x.shape) + (1,) * (nd - x.dim()))
        return torch.where(mask.reshape((-1,) + (1,) * (nd - 1)), pad(a),
                           pad(b))
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _select(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_select(mask, x, y) for x, y in zip(a, b))
    return a                        # static: the same in both


def _pytree_order(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Observation keys in sorted order: a JAX caller receives the TimeStep
    from a jitted reset/step, and JAX pytrees sort dict keys, so that is
    the order ``flatten_observation`` concatenates there (the task's own
    dict, as ``_observe`` returns it, keeps insertion order)."""
    return dict(sorted(obs.items()))


class Environment:
    """A task bound to a compiled model; episode state lives in EnvState."""

    def __init__(self, model: M.Model, task, time_limit: float = float('inf'),
                 control_timestep: Optional[float] = None,
                 contact_fn=None, max_reset_attempts: int = 1):
        self._model = model
        self._task = task
        if control_timestep is None:
            control_timestep = float(model.opt.timestep)
        self._n_sub_steps = engine.n_substeps(model, control_timestep)
        self._control_timestep = control_timestep
        self._max_steps = (np.iinfo(np.int32).max if time_limit == float('inf')
                           else int(round(time_limit / control_timestep)))
        # stored as JAX stores it; its engine never reads it either
        self._contact_fn = contact_fn
        self._obs_acc = bool(getattr(task, 'OBSERVES_ACC', True))
        if max_reset_attempts < 1:
            raise ValueError('max_reset_attempts must be >= 1')
        self._max_reset_attempts = int(max_reset_attempts)

    @property
    def model(self) -> M.Model:
        return self._model

    @property
    def task(self):
        return self._task

    @property
    def max_steps(self) -> int:
        return self._max_steps

    def control_timestep(self) -> float:
        return self._control_timestep

    def action_spec(self) -> BoundedArraySpec:
        return action_spec(self._model)

    def observation_spec(self) -> Dict[str, ArraySpec]:
        """Per-env shape of each observation, in the task's key order (the
        JAX method resets one env outside any jit, so its TimeStep keeps
        the task's order)."""
        phys, params = self._task.initialize_episode(
            self._model, 1, torch.Generator().manual_seed(0))
        obs = self._observe(self._model_with(params), phys, params)
        return {k: ArraySpec(v.shape[1:], str(v.dtype).split('.')[-1], k)
                for k, v in obs.items()}

    def _model_with(self, params) -> M.Model:
        """The model with the episodes' task params applied (per env)."""
        if hasattr(self._task, 'apply_params'):
            return self._task.apply_params(self._model, params)
        return self._model

    def reset(self, batch: int, generator: torch.Generator
              ) -> Tuple[EnvState, TimeStep]:
        """Start `batch` new episodes (randomized from `generator`).

        With ``max_reset_attempts`` N > 1 the task draws N - 1 more inits
        for all envs, one after another from `generator`; an env keeps its
        incumbent draw unless ``engine.diverged`` flags it, and then takes
        the next one (JAX's per-env ``where``). N = 1 draws once, so the
        generator's stream is that of a plain reset."""
        phys, params = self._task.initialize_episode(self._model, batch,
                                                     generator)
        for _ in range(1, self._max_reset_attempts):
            phys2, params2 = self._task.initialize_episode(
                self._model, batch, generator)
            bad = engine.diverged(phys)
            phys, params = (_select(bad, phys2, phys),
                            _select(bad, params2, params))
        return self.start(phys, params)

    def start(self, phys: M.State, params=()) -> Tuple[EnvState, TimeStep]:
        """EnvState and FIRST TimeStep for given initial physics states."""
        obs = _pytree_order(self._observe(self._model_with(params), phys,
                                          params))
        B, dev = phys.qpos.shape[0], phys.qpos.device
        state = EnvState(physics=phys, params=params,
                         step_count=torch.zeros((B,), dtype=torch.int32,
                                                device=dev),
                         last=torch.zeros((B,), dtype=torch.bool, device=dev))
        zero = torch.zeros((B,), dtype=phys.qpos.dtype, device=dev)
        return state, TimeStep(
            step_type=torch.full((B,), FIRST, dtype=torch.int32, device=dev),
            reward=zero, discount=zero + 1.0, observation=obs)

    def render(self, state: EnvState, height: int = 240, width: int = 320,
               camera_id=0, depth: bool = False,
               segmentation: bool = False) -> torch.Tensor:
        """Render every env's state through an MJCF camera (JAX
        control.py render): RGB (B, H, W, 3) in [0, 1], metric depth
        (B, H, W) or geom ids (B, H, W). With the task's
        ``visualize_reward`` set, an RGB frame tints the body geoms by the
        task's reward, for which the forward then runs to the acceleration
        stage where the task observes it."""
        from ..utils.raycast import Camera
        m = self._model_with(state.params)
        cam = Camera(m, height=height, width=width, camera_id=camera_id)
        phys = state.physics
        zero_ctrl = torch.zeros((phys.qpos.shape[0], m.nu),
                                dtype=phys.qpos.dtype, device=phys.qpos.device)
        need_reward = bool(getattr(self._task, 'visualize_reward', False)
                           and not depth and not segmentation)
        data = engine.forward(m, phys, zero_ctrl,
                              acc_stage=need_reward and self._obs_acc)
        reward = (self._task.get_reward(m, phys, data, zero_ctrl)
                  if need_reward else None)
        return cam.render(data, depth=depth, segmentation=segmentation,
                          reward=reward)

    def _observe(self, m, phys, params):
        # acc_stage follows the task's OBSERVES_ACC: in the JAX package XLA
        # drops the unused constraint solve of this pass; eager PyTorch
        # would run it, so it is skipped explicitly (same observation).
        ctrl = torch.zeros((phys.qpos.shape[0], m.nu), dtype=phys.qpos.dtype,
                           device=phys.qpos.device)
        data = engine.forward(m, phys, ctrl, acc_stage=self._obs_acc)
        return self._task.get_observation(m, phys, data)

    def step(self, state: EnvState, action: torch.Tensor
             ) -> Tuple[EnvState, TimeStep]:
        """One control step: before_step -> N physics substeps -> reward."""
        new_state, ts, _ = self.step_with_data(state, action)
        return new_state, ts

    def step_with_data(self, state: EnvState, action: torch.Tensor):
        """`step` that also returns the post-step forward Data."""
        m = self._model_with(state.params)
        ctrl = self._task.before_step(action, m)
        phys = engine.substep(m, state.physics, ctrl, self._n_sub_steps)
        data = engine.forward(m, phys, ctrl, acc_stage=self._obs_acc)
        obs = _pytree_order(self._task.get_observation(m, phys, data))
        reward = self._task.get_reward(m, phys, data, ctrl)
        step_count = state.step_count + 1
        is_last = step_count >= self._max_steps
        discount = torch.ones_like(phys.time)
        if hasattr(self._task, 'get_termination'):
            # early termination ends the episode with the task's discount
            terminated, term_discount = self._task.get_termination(
                m, phys, data)
            is_last = is_last | terminated
            discount = torch.where(terminated, term_discount.to(
                discount.dtype), discount)
        step_type = torch.where(is_last, LAST, MID).to(torch.int32)
        new_state = EnvState(physics=phys, params=state.params,
                             step_count=step_count, last=is_last)
        return new_state, TimeStep(step_type=step_type,
                                   reward=reward.to(phys.qpos.dtype),
                                   discount=discount, observation=obs), data

    def autoreset_step(self, state: EnvState, action: torch.Tensor,
                       generator: torch.Generator
                       ) -> Tuple[EnvState, TimeStep]:
        """`step` that restarts an env after its LAST step (time limit or
        early termination) or once its physics diverged: that env's new
        episode starts from a reset drawn from `generator` and returns
        FIRST. Both branches run for every env and ``torch.where`` picks
        (JAX control.py autoreset_step)."""
        stepped_state, stepped_ts = self.step(state, action)
        reset_state, reset_ts = self.reset(state.physics.qpos.shape[0],
                                           generator)
        was_last = state.last | engine.diverged(state.physics)
        return (_select(was_last, reset_state, stepped_state),
                _select(was_last, reset_ts, stepped_ts))

