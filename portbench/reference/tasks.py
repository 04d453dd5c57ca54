"""The plain reference of walker walk and cheetah run, on the reference
physics in ``reference/physics`` (a frozen copy of the port's plain
PyTorch physics, with the plain APGD iterates). It imports nothing of the
program: the model XMLs, the episode draws, the observations and the
rewards are copied here from the dm_control suite's walker and cheetah as
the port has them (``mujoco_mbrl_tpu_torch/suite/{walker,cheetah}.py``).
Every function takes the env batch as the leading dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from .physics import engine, mjcf
from .physics import model as M

WALKER_XML = """
<mujoco model='planar walker'>
  <option timestep='0.0025'/>
  <default>
    <joint damping='.1' armature='0.01' limited='true'
           solimplimit='0 .99 .01'/>
    <geom contype='1' conaffinity='0' friction='.7 .1 .1'/>
    <motor ctrlrange='-1 1' ctrllimited='true'/>
    <default class='walker'>
      <geom type='capsule'/>
      <joint axis='0 -1 0'/>
    </default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' conaffinity='1' pos='248 0 0'
          size='250 .8 .2' zaxis='0 0 1'/>
    <body name='torso' pos='0 0 1.3' childclass='walker'>
      <camera name='side' pos='0 -2 .7' euler='60 0 0' mode='trackcom'/>
      <camera name='back' pos='-2 0 .5' xyaxes='0 -1 0 1 0 3' mode='trackcom'/>
      <joint name='rootz' axis='0 0 1' type='slide' limited='false'
             armature='0' damping='0'/>
      <joint name='rootx' axis='1 0 0' type='slide' limited='false'
             armature='0' damping='0'/>
      <joint name='rooty' axis='0 1 0' type='hinge' limited='false'
             armature='0' damping='0'/>
      <geom name='torso' size='0.07 0.3'/>
      <body name='right_thigh' pos='0 -.05 -0.3'>
        <joint name='right_hip' range='-20 100'/>
        <geom name='right_thigh' pos='0 0 -0.225' size='0.05 0.225'/>
        <body name='right_leg' pos='0 0 -0.7'>
          <joint name='right_knee' pos='0 0 0.25' range='-150 0'/>
          <geom name='right_leg' size='0.04 0.25'/>
          <body name='right_foot' pos='0.06 0 -0.25'>
            <joint name='right_ankle' pos='-0.06 0 0' range='-45 45'/>
            <geom name='right_foot' zaxis='1 0 0' size='0.05 0.1'/>
          </body>
        </body>
      </body>
      <body name='left_thigh' pos='0 .05 -0.3'>
        <joint name='left_hip' range='-20 100'/>
        <geom name='left_thigh' pos='0 0 -0.225' size='0.05 0.225'/>
        <body name='left_leg' pos='0 0 -0.7'>
          <joint name='left_knee' pos='0 0 0.25' range='-150 0'/>
          <geom name='left_leg' size='0.04 0.25'/>
          <body name='left_foot' pos='0.06 0 -0.25'>
            <joint name='left_ankle' pos='-0.06 0 0' range='-45 45'/>
            <geom name='left_foot' zaxis='1 0 0' size='0.05 0.1'/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='right_hip' joint='right_hip' gear='100'/>
    <motor name='right_knee' joint='right_knee' gear='50'/>
    <motor name='right_ankle' joint='right_ankle' gear='20'/>
    <motor name='left_hip' joint='left_hip' gear='100'/>
    <motor name='left_knee' joint='left_knee' gear='50'/>
    <motor name='left_ankle' joint='left_ankle' gear='20'/>
  </actuator>
</mujoco>
"""

CHEETAH_XML = """
<mujoco model='cheetah'>
  <compiler settotalmass='14'/>
  <option timestep='0.01'/>
  <default>
    <default class='cheetah'>
      <joint limited='true' damping='.01' armature='.1' stiffness='8'
             type='hinge' axis='0 1 0'/>
      <geom contype='1' conaffinity='1' condim='3' friction='.4 .1 .1'/>
    </default>
    <default class='free'>
      <joint limited='false' damping='0' armature='0' stiffness='0'/>
    </default>
    <motor ctrllimited='true' ctrlrange='-1 1'/>
  </default>
  <worldbody>
    <geom name='ground' type='plane' conaffinity='1' pos='98 0 0'
          size='100 .8 .5'/>
    <body name='torso' pos='0 0 .7' childclass='cheetah'>
      <camera name='side' pos='0 -3 0' quat='0.707 0.707 0 0' mode='trackcom'/>
      <camera name='back' pos='-1.8 -1.3 0.8' xyaxes='0.45 -0.9 0 0.3 0.15 0.94' mode='trackcom'/>
      <joint name='rootx' type='slide' axis='1 0 0' class='free'/>
      <joint name='rootz' type='slide' axis='0 0 1' class='free'/>
      <joint name='rooty' type='hinge' axis='0 1 0' class='free'/>
      <geom name='torso' type='capsule' fromto='-.5 0 0 .5 0 0'
            size='0.046'/>
      <geom name='head' type='capsule' pos='.6 0 .1' euler='0 50 0'
            size='0.046 .15'/>
      <body name='bthigh' pos='-.5 0 0'>
        <joint name='bthigh' range='-30 60' stiffness='240' damping='6'/>
        <geom name='bthigh' type='capsule' pos='.1 0 -.13' euler='0 -218 0'
              size='0.046 .145'/>
        <body name='bshin' pos='.16 0 -.25'>
          <joint name='bshin' range='-50 50' stiffness='180' damping='4.5'/>
          <geom name='bshin' type='capsule' pos='-.14 0 -.07'
                euler='0 -116 0' size='0.046 .15'/>
          <body name='bfoot' pos='-.28 0 -.14'>
            <joint name='bfoot' range='-230 50' stiffness='120' damping='3'/>
            <geom name='bfoot' type='capsule' pos='.03 0 -.097'
                  euler='0 -15 0' size='0.046 .094'/>
          </body>
        </body>
      </body>
      <body name='fthigh' pos='.5 0 0'>
        <joint name='fthigh' range='-57 .40' stiffness='180' damping='4.5'/>
        <geom name='fthigh' type='capsule' pos='-.07 0 -.12' euler='0 30 0'
              size='0.046 .133'/>
        <body name='fshin' pos='-.14 0 -.24'>
          <joint name='fshin' range='-70 50' stiffness='120' damping='3'/>
          <geom name='fshin' type='capsule' pos='.065 0 -.09'
                euler='0 -34 0' size='0.046 .106'/>
          <body name='ffoot' pos='.13 0 -.18'>
            <joint name='ffoot' range='-28 28' stiffness='60' damping='1.5'/>
            <geom name='ffoot' type='capsule' pos='.045 0 -.07'
                  euler='0 -34 0' size='0.046 .07'/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='bthigh' joint='bthigh' gear='120'/>
    <motor name='bshin' joint='bshin' gear='90'/>
    <motor name='bfoot' joint='bfoot' gear='60'/>
    <motor name='fthigh' joint='fthigh' gear='90'/>
    <motor name='fshin' joint='fshin' gear='60'/>
    <motor name='ffoot' joint='ffoot' gear='30'/>
  </actuator>
</mujoco>
"""

_STAND_HEIGHT = 1.2
_WALK_SPEED = 1
_RUN_SPEED = 10
_CHEETAH_SETTLE_STEPS = 200


def _sigmoid_linear(x, value_at_1):
    scaled = x * (1 - value_at_1)
    return torch.where(scaled.abs() < 1, 1 - scaled.abs(), 0.0)


def _sigmoid_gaussian(x, value_at_1):
    scale = np.sqrt(-2 * np.log(value_at_1))
    return torch.exp(-0.5 * (x * scale) ** 2)


def tolerance(x, lower, upper, margin, sigmoid, value_at_margin=0.1):
    """dm_control's ``rewards.tolerance`` for the two sigmoids used here."""
    in_bounds = (lower <= x) & (x <= upper)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    fn = _sigmoid_linear if sigmoid == 'linear' else _sigmoid_gaussian
    return torch.where(in_bounds, 1.0, fn(d, value_at_margin))


def subtree_bodies(m, root):
    out = []
    for b in range(root, m.nbody):
        p = b
        while p >= root:
            if p == root:
                out.append(b)
                break
            p = m.body_parent[p]
    return out


def subtree_linvel(m, data, root):
    """(B, 3) linear velocity of the subtree's centre of mass."""
    bodies = subtree_bodies(m, root)
    cvel = data.cvel[:, bodies]
    v = cvel[..., 3:] + torch.linalg.cross(cvel[..., :3],
                                           data.xipos[:, bodies])
    mass = m.body_mass[bodies]
    return (mass[:, None] * v).sum(1) / torch.clamp(mass.sum(), min=1e-12)


class Task:
    """One of the two tasks on a reference model of ``dtype``."""

    def __init__(self, name: str, device, dtype=torch.float64):
        self.name = name
        xml = {'walker_walk': WALKER_XML, 'cheetah_run': CHEETAH_XML}[name]
        self.model = mjcf.parse(xml, dtype=dtype).to(device)
        # walker: 10 substeps of 2.5 ms a 25 ms control step; cheetah: 1
        self.n_sub = 10 if name == 'walker_walk' else 1

    def state(self, qpos, qvel, time) -> M.State:
        return M.State(qpos=qpos, qvel=qvel, time=time)

    def reset(self, batch: int, generator: torch.Generator,
              rows=None) -> M.State:
        """The episode draws of ``batch`` envs, in the order and the float32
        precision the suite draws them from ``generator``, kept for
        ``rows`` (all by default), then (cheetah) 200 settling steps of
        zero control with the time set back to 0."""
        m = self.model
        qpos = m.qpos0.expand(batch, m.nq).clone()
        rng = m.jnt_range.cpu().numpy()
        for j in range(m.njnt):
            if self.name == 'walker_walk' and not m.jnt_limited[j]:
                if m.jnt_type[j] != M.HINGE:
                    continue
                lo, hi = -np.pi, np.pi
            elif m.jnt_limited[j]:
                lo, hi = float(rng[j, 0]), float(rng[j, 1])
            else:
                continue
            u = torch.rand((batch,), generator=generator,
                           dtype=torch.float32, device=generator.device)
            qpos[:, m.jnt_qposadr[j]] = (lo + (hi - lo) * u).to(
                qpos.device, qpos.dtype)
        if rows is not None:
            qpos = qpos[rows]
        state = M.make_state(m, qpos=qpos)
        if self.name == 'cheetah_run':
            zero = torch.zeros((qpos.shape[0], m.nu), dtype=qpos.dtype,
                               device=qpos.device)
            for _ in range(_CHEETAH_SETTLE_STEPS):
                state = engine.step(m, state, zero)
            state = state.replace(time=torch.zeros_like(state.time))
        return state

    def observe(self, state: M.State) -> torch.Tensor:
        """(B, obs_dim): the observation dict in sorted key order, flat."""
        m = self.model
        zero = torch.zeros((state.qpos.shape[0], m.nu),
                           dtype=state.qpos.dtype, device=state.qpos.device)
        data = engine.forward(m, state, zero, acc_stage=False)
        return self._obs(state, data)

    def _obs(self, state, data):
        B = state.qpos.shape[0]
        if self.name == 'cheetah_run':
            return torch.cat([state.qpos[:, 1:], state.qvel], 1)
        torso = self.model.name2id('body', 'torso')
        orient = data.ximat[:, 1:, 0][:, :, [0, 2]].reshape(B, -1)
        return torch.cat([data.xpos[:, torso, 2][:, None], orient,
                          state.qvel], 1)

    def _reward(self, data):
        m = self.model
        torso = m.name2id('body', 'torso')
        speed = subtree_linvel(m, data, torso)[:, 0]
        if self.name == 'cheetah_run':
            return tolerance(speed, _RUN_SPEED, float('inf'), _RUN_SPEED,
                             'linear', 0.0)
        standing = tolerance(data.xpos[:, torso, 2], _STAND_HEIGHT,
                             float('inf'), _STAND_HEIGHT / 2, 'gaussian')
        upright = (1 + data.ximat[:, torso, 2, 2]) / 2
        stand = (3 * standing + upright) / 4
        move = tolerance(speed, _WALK_SPEED, float('inf'), _WALK_SPEED / 2,
                         'linear', 0.5)
        return stand * (5 * move + 1) / 6

    def step(self, state: M.State, action: torch.Tensor):
        """One control step: (next state, observation, reward)."""
        m = self.model
        phys = engine.substep(m, state, action, self.n_sub)
        data = engine.forward(m, phys, action, acc_stage=False)
        return phys, self._obs(phys, data), self._reward(data)
