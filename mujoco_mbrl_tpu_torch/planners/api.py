"""Class-style planner API (port of mujoco_mbrl_tpu/planners/api.py).

Only ``CEMPlanner.defaults`` is ported: the agents plan through the
batched CEM (``shooting.cem_batched``). The per-env ``plan`` and the other
planners are not.
"""

from __future__ import annotations


class CEMPlanner:
    defaults = dict(num_candidates=1000, num_elites=100, num_iterations=5,
                    action_low=-1.0, action_high=1.0)

    @classmethod
    def plan(cls, *args, **kwargs):
        raise NotImplementedError(
            'the per-env CEM plan is not ported '
            '(mujoco_mbrl_tpu.planners.api.CEMPlanner.plan)')
