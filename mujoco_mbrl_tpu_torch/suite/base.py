"""Task base class (port of mujoco_mbrl_tpu/suite/base.py)."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..physics import model as M


class Task:
    """Base task: zero-randomization episode init, pass-through actions.

    ``OBSERVES_ACC`` says whether observation or reward read any
    acceleration-stage Data field; tasks that do not set it False so the
    per-step observation forward skips the actuation model and the
    constraint solve.
    """

    OBSERVES_ACC = True

    # reward-keyed render tint (reference suite/base.py:90-97), read by
    # Environment.render, which blends body geoms toward the highlight
    # colour by reward**4
    _visualize_reward = False

    @property
    def visualize_reward(self) -> bool:
        return self._visualize_reward

    @visualize_reward.setter
    def visualize_reward(self, value) -> None:
        if not isinstance(value, bool):
            raise ValueError(f'Expected a boolean, got {type(value)}.')
        self._visualize_reward = value

    def initialize_episode(self, model: M.Model, batch: int,
                           generator: torch.Generator) -> Tuple[M.State, Any]:
        return M.make_state(model, batch=batch), ()

    def apply_params(self, model: M.Model, params: Any) -> M.Model:
        """Merge per-episode overrides into the model. Default: none."""
        return model

    def before_step(self, action: torch.Tensor, model: M.Model):
        return action

    def get_observation(self, model: M.Model, phys: M.State, data: M.Data):
        raise NotImplementedError

    def get_reward(self, model: M.Model, phys: M.State, data: M.Data,
                   ctrl: torch.Tensor):
        raise NotImplementedError
