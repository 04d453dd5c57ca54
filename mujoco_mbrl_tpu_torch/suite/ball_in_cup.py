"""Ball-in-cup domain: catch.

Port of mujoco_mbrl_tpu/suite/ball_in_cup.py. The model XML is this
package's own copy of the JAX module's ``_XML`` (a test checks the two are
equal). The string is a length-limited spatial tendon (one limit row);
the ball meets the cup's five capsules as 5 sphere-capsule points of 4
pyramid facets: 21 constraint rows, which the dense APGD kernel solves one
env per warp, 10 substeps a control step.
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02

# the target site's half-sizes and offset from the cup body (the JAX
# module keeps the reward constants in the task)
_TARGET_SIZE_X = .05
_TARGET_SIZE_Z = .05
_TARGET_OFFSET_Z = -.05

_XML = """
<mujoco model='ball in cup'>
  <default>
    <motor ctrllimited='true' ctrlrange='-1 1' gear='5'/>
    <default class='cup'>
      <joint type='slide' damping='3' stiffness='20'/>
      <geom type='capsule' size='.008'/>
    </default>
  </default>
  <worldbody>
    <body name='cup' pos='0 0 .6' childclass='cup'>
      <joint name='cup_x' axis='1 0 0'/>
      <joint name='cup_z' axis='0 0 1'/>
      <geom name='cup_part_0' fromto='-.05 0 0 -.05 0 -.075'/>
      <geom name='cup_part_1' fromto='-.05 0 -.075 -.025 0 -.1'/>
      <geom name='cup_part_2' fromto='-.025 0 -.1 .025 0 -.1'/>
      <geom name='cup_part_3' fromto='.025 0 -.1 .05 0 -.075'/>
      <geom name='cup_part_4' fromto='.05 0 -.075 .05 0 0'/>
      <site name='cup' pos='0 0 -.108'/>
    </body>
    <body name='ball' pos='0 0 .2'>
      <joint name='ball_x' type='slide' axis='1 0 0'/>
      <joint name='ball_z' type='slide' axis='0 0 1'/>
      <geom name='ball' type='sphere' size='.025'/>
      <site name='ball'/>
    </body>
  </worldbody>
  <actuator>
    <motor name='x' joint='cup_x'/>
    <motor name='z' joint='cup_z'/>
  </actuator>
  <tendon>
    <spatial name='string' limited='true' range='0 0.3' width='0.003'>
      <site site='ball'/>
      <site site='cup'/>
    </spatial>
  </tendon>
</mujoco>
"""


class BallInCup(base.Task):
    """Swing the ball into the cup; sparse reward."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    _INIT_ATTEMPTS = 8

    def initialize_episode(self, model, batch, generator):
        """Collision-free random ball positions (JAX ball_in_cup.py:77-96):
        ``_INIT_ATTEMPTS`` draws an env, the first without penetration
        kept."""
        A, dt = self._INIT_ATTEMPTS * batch, model.dtype
        qposes = model.qpos0.expand(A, model.nq).clone()
        for name, lo, hi in (('ball_x', -.2, .2), ('ball_z', .2, .5)):
            u = torch.rand((A,), generator=generator, dtype=dt,
                           device=generator.device).to(model.device)
            adr = model.jnt_qposadr[model.names['joint'][name]]
            qposes[:, adr] = lo + (hi - lo) * u
        qpos = randomizers.first_collision_free(
            model, qposes.reshape(self._INIT_ATTEMPTS, batch, model.nq))
        return make_state(model, qpos=qpos), ()

    def get_observation(self, model, phys, data):
        return {'position': phys.qpos, 'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        cup = model.name2id('body', 'cup')
        ball = model.name2id('body', 'ball')
        target = data.xpos[:, cup]
        d = torch.stack([target[:, 0] - data.xpos[:, ball, 0],
                         target[:, 2] + _TARGET_OFFSET_Z
                         - data.xpos[:, ball, 2]], 1).abs()
        ball_size = M.cached(model, 'ball_size', lambda: float(
            model.geom_size[model.name2id('geom', 'ball'), 0]))
        lim = torch.tensor([_TARGET_SIZE_X - ball_size,
                            _TARGET_SIZE_Z - ball_size], dtype=d.dtype,
                           device=d.device)
        return (d < lim).all(1).to(phys.qpos.dtype)


@SUITE.add('benchmarking', 'easy')
def catch(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    model = mjcf.parse(_XML).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, BallInCup(), time_limit=time_limit,
                               **kwargs)
