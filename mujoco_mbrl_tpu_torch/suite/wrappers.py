"""Observation / action wrappers for suite environments.

Port of mujoco_mbrl_tpu/suite/wrappers.py (the reference's
``dm_control/dm_control/suite/wrappers/pixels.py:30-119`` and
``action_noise.py:30-73``): each wrapper forwards to the Environment it
wraps and keeps its batched reset / step. The pixels are rendered for
the whole env batch on the env's device: through the camera ray caster
(utils.raycast) when the model has a camera, else through the
orthographic rasterizer (utils.render).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..physics import engine
from ..utils import render as render_mod
from ..utils.raycast import Camera
from . import control


class PixelWrapper:
    """Adds (or replaces observations with) rendered pixels (B, H, W, 3)."""

    def __init__(self, env: control.Environment, pixels_only: bool = True,
                 height: int = 64, width: int = 64,
                 observation_key: str = 'pixels',
                 plane: str = 'xz', extent: float = 2.0,
                 camera_id=None):
        self._env = env
        self._pixels_only = pixels_only
        self._key = observation_key
        self._height = height
        self._width = width
        self._plane = plane
        self._extent = extent
        # camera-posed perspective rendering when the model defines
        # cameras (the reference pixels wrapper's camera_id); None takes
        # camera 0 if any exists, else the orthographic rasterizer
        self._camera = None
        model = env.model
        if camera_id is None and model.ncam:
            camera_id = 0
        if camera_id is not None:
            self._camera = Camera(model, height, width, camera_id)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def render(self, env_state: control.EnvState) -> torch.Tensor:
        """(B, H, W, 3) float RGB in [0, 1] of each env's configuration;
        rendering reads the kinematics only (no constraint solve)."""
        m = self._env._model_with(env_state.params)
        phys = env_state.physics
        data = engine.forward(
            m, phys, torch.zeros((phys.qpos.shape[0], m.nu),
                                 dtype=phys.qpos.dtype,
                                 device=phys.qpos.device),
            acc_stage=False)
        if self._camera is not None:
            return self._camera.render(data)
        return render_mod.render(m, data, self._height, self._width,
                                 plane=self._plane, extent=self._extent)

    def _add_pixels(self, env_state, ts):
        pixels = self.render(env_state)
        if self._pixels_only:
            obs = {self._key: pixels}
        else:
            obs = dict(ts.observation)
            obs[self._key] = pixels
        return dataclasses.replace(ts, observation=obs)

    def reset(self, batch: int, generator: torch.Generator):
        env_state, ts = self._env.reset(batch, generator)
        return env_state, self._add_pixels(env_state, ts)

    def step(self, env_state, action):
        env_state, ts = self._env.step(env_state, action)
        return env_state, self._add_pixels(env_state, ts)

    def step_with_data(self, env_state, action):
        # keep the wrapper on the data-reusing collection path:
        # __getattr__ forwarding would skip the pixels
        env_state, ts, data = self._env.step_with_data(env_state, action)
        return env_state, self._add_pixels(env_state, ts), data


class ActionNoiseWrapper:
    """Adds iid Gaussian noise to actions, scaled to the ctrlrange
    (action_noise.py:30-73). The noise is drawn from an explicit
    ``torch.Generator``: the one a step is given, else the wrapper's own
    (``generator``, or one seeded 0 on the env's device)."""

    def __init__(self, env: control.Environment, scale: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        self._env = env
        self._scale = scale
        spec = env.action_spec()
        lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
        hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
        dev, dt = env.model.device, env.model.dtype
        self._minimum = torch.as_tensor(lo, dtype=dt, device=dev)
        self._maximum = torch.as_tensor(hi, dtype=dt, device=dev)
        self._std = self._scale * (self._maximum - self._minimum)
        self._generator = (generator if generator is not None
                           else torch.Generator(device=dev).manual_seed(0))

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, batch: int, generator: torch.Generator):
        return self._env.reset(batch, generator)

    def noisy(self, action: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``action`` plus the scaled noise, clipped to the ctrlrange."""
        g = generator if generator is not None else self._generator
        eps = torch.randn(action.shape, generator=g, dtype=action.dtype,
                          device=g.device).to(action.device)
        return torch.clamp(action + self._std * eps, self._minimum,
                           self._maximum)

    def step(self, env_state, action,
             generator: Optional[torch.Generator] = None):
        return self._env.step(env_state, self.noisy(action, generator))

    def step_with_data(self, env_state, action,
                       generator: Optional[torch.Generator] = None):
        # mirror step(): __getattr__ forwarding would bypass the noise
        return self._env.step_with_data(env_state,
                                        self.noisy(action, generator))


# dm_control-compatible alias
Wrapper = PixelWrapper
