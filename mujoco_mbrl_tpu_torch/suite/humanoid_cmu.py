"""Humanoid_CMU domain: stand / run, the 56-hinge CMU-skeleton humanoid.

Port of mujoco_mbrl_tpu/suite/humanoid_cmu.py. The model XML is this
package's own copy of the JAX module's ``_make_xml`` (a test checks the
two are equal): a free root and 56 limited hinges (nq 63, nv 62), 31
bodies, 50 geoms (capsules, spheres, two ellipsoid hands, a plane floor;
every one condim 3) and five ``<contact><exclude>`` body pairs. Its 1,035
candidate pairs after the five excludes give 4,352 constraint rows (56
joint limits, 1,074 contact points of 4 facet rows), past the 1024 rows
that the dense kernel's one-thread-a-row paths take, and kept dense by
the JAX regime rule (``physics.solver.factored_fits(4352, 62)`` is
False): each solve
takes ``ops.apgd_solve.apgd_iterate_dense_factors``, JAX's dense iterate
with Ad applied through J~ and M^-1 and never formed. A control step is
10 Euler substeps of 2 ms, 10 solves; the observation reads only the
position and velocity stages.
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from . import base, control, randomizers, rewards, sensors
from .randomizers import first_collision_free
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = 0.02
_STAND_HEIGHT = 1.4
_RUN_SPEED = 10

# (name, gear) per motor, one per non-root joint (humanoid_CMU.xml
# actuator block; joint name == motor name throughout)
_MOTORS = [
    ('headrx', 20), ('headry', 20), ('headrz', 20),
    ('lclaviclery', 20), ('lclaviclerz', 20),
    ('lfemurrx', 120), ('lfemurry', 40), ('lfemurrz', 40),
    ('lfingersrx', 20), ('lfootrx', 20), ('lfootrz', 20),
    ('lhandrx', 20), ('lhandrz', 20),
    ('lhumerusrx', 40), ('lhumerusry', 40), ('lhumerusrz', 40),
    ('lowerbackrx', 40), ('lowerbackry', 40), ('lowerbackrz', 40),
    ('lowerneckrx', 20), ('lowerneckry', 20), ('lowerneckrz', 20),
    ('lradiusrx', 40), ('lthumbrx', 20), ('lthumbrz', 20),
    ('ltibiarx', 80), ('ltoesrx', 20), ('lwristry', 20),
    ('rclaviclery', 20), ('rclaviclerz', 20),
    ('rfemurrx', 120), ('rfemurry', 40), ('rfemurrz', 40),
    ('rfingersrx', 20), ('rfootrx', 20), ('rfootrz', 20),
    ('rhandrx', 20), ('rhandrz', 20),
    ('rhumerusrx', 40), ('rhumerusry', 40), ('rhumerusrz', 40),
    ('rradiusrx', 40), ('rthumbrx', 20), ('rthumbrz', 20),
    ('rtibiarx', 80), ('rtoesrx', 20), ('rwristry', 20),
    ('thoraxrx', 40), ('thoraxry', 40), ('thoraxrz', 40),
    ('upperbackrx', 40), ('upperbackry', 40), ('upperbackrz', 40),
    ('upperneckrx', 20), ('upperneckry', 20), ('upperneckrz', 20),
]


def _leg(s, sgn):
    """One leg subtree (s in 'lr', sgn = +1 left / -1 right)."""
    fz = (f"<joint name='{s}femurrz' axis='0 0 1' range='-60 70' "
          "class='stiff_medium'/>" if s == 'l' else
          f"<joint name='{s}femurrz' axis='0 0 1' range='-70 60' "
          "class='stiff_medium'/>")
    foot_rz = ("range='-70 20'" if s == 'l' else "range='-20 70'")
    return f"""
      <body name='{s}hipjoint'>
        <geom name='{s}hipjoint' size='0.008 0.022'
              pos='{sgn * 0.051} -0.046 0.025'
              quat='{0.5708 if s == 'l' else 0.574856}
                    {-0.566602 if s == 'l' else -0.547594}
                    {-0.594264 if s == 'l' else 0.608014} 0'/>
        <body name='{s}femur' pos='{sgn * 0.102} -0.092 0.05'
              quat='1 0 0 {sgn * 0.17365}'>
          {fz}
          <joint name='{s}femurry' axis='0 1 0' range='-70 70'
                 class='stiff_medium'/>
          <joint name='{s}femurrx' axis='1 0 0' range='-160 20'
                 class='stiff_medium'/>
          <geom name='{s}femur' size='0.06 0.17'
                pos='{-sgn * 0.01} -0.202473 0'
                quat='0.7 -0.7 {sgn * -0.1228} {sgn * -0.07}'/>
          <body name='{s}tibia' pos='0 -0.404945 0'>
            <joint name='{s}tibiarx' axis='1 0 0' range='1 170'
                   class='stiff_low'/>
            <geom name='{s}tibia' size='0.03 0.1825614' pos='0 -0.202846 0'
                  quat='0.7 -0.7 {sgn * -0.1228} {sgn * -0.1228}'/>
            <geom name='{s}calf' size='0.045 0.08' pos='0 -0.1 -.01'
                  quat='0.7 -0.7 -0.1228 -0.1228'/>
            <body name='{s}foot' pos='0 -0.405693 0'
                  quat='0.707107 -0.707107 0 0'>
              <joint name='{s}footrz' axis='0 0 1' {foot_rz}
                     class='stiff_medium'/>
              <joint name='{s}footrx' axis='1 0 0' range='-45 90'
                     class='stiff_medium'/>
              <geom name='{s}foot0' size='0.02 0.06'
                    pos='{-sgn * 0.02} -0.023 -0.01'
                    euler='100 {-sgn * 2} 0'/>
              <geom name='{s}foot1' size='0.02 0.06' pos='0 -0.023 -0.01'
                    euler='100 0 0'/>
              <geom name='{s}foot2' size='0.02 0.06'
                    pos='{sgn * 0.01} -0.023 -0.01'
                    euler='100 {sgn * 10} 0'/>
              <body name='{s}toes' pos='0 -0.106372 -0.0227756'>
                <joint name='{s}toesrx' axis='1 0 0' range='-90 20'/>
                <geom name='{s}toes0' type='sphere' size='0.02'
                      pos='{-sgn * 0.025} -0.01 -.01'/>
                <geom name='{s}toes1' type='sphere' size='0.02'
                      pos='0 -0.005 -.01'/>
                <geom name='{s}toes2' type='sphere' size='0.02'
                      pos='{sgn * 0.02} .001 -.01'/>
              </body>
            </body>
          </body>
        </body>
      </body>"""


def _arm(s, sgn):
    """One arm subtree hanging off the thorax."""
    clav_rz = ("range='0 20'" if s == 'l' else "range='-20 0'")
    clav_ry = ("range='-20 10'" if s == 'l' else "range='-10 20'")
    hum_quat = ('0.18 0.68 -0.68 0.18' if s == 'l'
                else '0.18 0.68 0.68 -0.18')
    return f"""
            <body name='{s}clavicle' pos='0 0.113945 0.00468037'>
              <joint name='{s}claviclerz' axis='0 0 1' {clav_rz}
                     class='stiff_high'/>
              <joint name='{s}claviclery' axis='0 1 0' {clav_ry}
                     class='stiff_high'/>
              <geom name='{s}clavicle' size='0.08 0.04'
                    pos='{sgn * 0.09} 0.05 -.01'
                    quat='1 0 -1 {-sgn * 0.4}'/>
              <body name='{s}humerus' pos='{sgn * 0.183} 0.076 0.01'
                    quat='{hum_quat}'>
                <joint name='{s}humerusrz' axis='0 0 1' range='-90 90'
                       class='stiff_low'/>
                <joint name='{s}humerusry' axis='0 1 0' range='-90 90'
                       class='stiff_low'/>
                <joint name='{s}humerusrx' axis='1 0 0' range='-60 90'
                       class='stiff_low'/>
                <geom name='{s}humerus' size='0.035 0.124' pos='0 -0.138 0'
                      quat='0.612 -0.612 {sgn * 0.35} {sgn * 0.35}'/>
                <body name='{s}radius' pos='0 -0.277 0'>
                  <joint name='{s}radiusrx' axis='1 0 0' range='-10 170'
                         class='stiff_low'/>
                  <geom name='{s}radius' size='0.03 0.06' pos='0 -0.08 0'
                        quat='0.612 -0.612 {sgn * 0.35} {sgn * 0.35}'/>
                  <body name='{s}wrist' pos='0 -0.17 0'
                        quat='-0.5 0 {sgn * 0.866} 0'>
                    <joint name='{s}wristry' axis='0 1 0' range='-180 0'/>
                    <geom name='{s}wrist' size='0.025 0.03' pos='0 -0.02 0'
                          quat='0 0 {-sgn} {-sgn}'/>
                    <body name='{s}hand' pos='0 -0.08 0'>
                      <joint name='{s}handrz' axis='0 0 1' range='-45 45'/>
                      <joint name='{s}handrx' axis='1 0 0' range='-90 90'/>
                      <geom name='{s}hand' type='ellipsoid'
                            size='.048 0.02 0.06' pos='0 -0.047 0'
                            quat='0 0 {-sgn} {-sgn}'/>
                      <body name='{s}fingers' pos='0 -0.08 0'>
                        <joint name='{s}fingersrx' axis='1 0 0'
                               range='0 90'/>
                        <geom name='{s}finger0' size='0.01 0.04'
                              pos='{-sgn * 0.03} -0.05 0' quat='1 -1 0 0'/>
                        <geom name='{s}finger1' size='0.01 0.04'
                              pos='{-sgn * 0.008} -0.06 0' quat='1 -1 0 0'/>
                        <geom name='{s}finger2' size='0.009 0.04'
                              pos='{sgn * 0.014} -0.06 0' quat='1 -1 0 0'/>
                        <geom name='{s}finger3' size='0.008 0.04'
                              pos='{sgn * 0.032} -0.05 0' quat='1 -1 0 0'/>
                      </body>
                      <body name='{s}thumb'
                            pos='{-sgn * 0.02} -.03 0'
                            quat='0.92388 0 0 {-sgn * 0.382683}'>
                        <joint name='{s}thumbrz' axis='0 0 1'
                               range='-45 45'/>
                        <joint name='{s}thumbrx' axis='1 0 0'
                               range='0 90'/>
                        <geom name='{s}thumb' size='0.012 0.04'
                              pos='0 -0.06 0' quat='0 0 {-sgn} {-sgn}'/>
                      </body>
                    </body>
                  </body>
                </body>
              </body>
            </body>"""


def _spine_triplet(name, cls, rx_range='-20 45'):
    return (f"<joint name='{name}rz' axis='0 0 1' range='-30 30' "
            f"class='{cls}'/>"
            f"<joint name='{name}ry' axis='0 1 0' range='-30 30' "
            f"class='{cls}'/>"
            f"<joint name='{name}rx' axis='1 0 0' range='{rx_range}' "
            f"class='{cls}'/>")


def _make_xml() -> str:
    motors = ''.join(
        f"<motor name='{n}' joint='{n}' gear='{g}'/>" for n, g in _MOTORS)
    return f"""
<mujoco model='humanoid_CMU'>
  <default>
    <joint limited='true' solimplimit='0 0.99 0.01' stiffness='0.1'
           armature='.01' damping='1'/>
    <geom friction='0.7' solref='0.015 1' solimp='0.95 0.99 0.003'/>
    <motor ctrllimited='true' ctrlrange='-1 1'/>
    <default class='humanoid'>
      <geom type='capsule'/>
      <default class='stiff_low'>
        <joint stiffness='.5' damping='4'/>
      </default>
      <default class='stiff_medium'>
        <joint stiffness='10' damping='5'/>
      </default>
      <default class='stiff_high'>
        <joint stiffness='30' damping='10'/>
      </default>
    </default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' conaffinity='1' size='100 100 .2'/>
    <body name='root' childclass='humanoid' pos='0 0 1' euler='90 0 0'>
      <site name='root' type='sphere' size='.01'/>
      <freejoint name='root'/>
      <geom name='root_geom' size='0.09 0.06' pos='0 -0.05 0'
            quat='1 0 -1 0'/>
      {_leg('l', 1)}
      {_leg('r', -1)}
      <body name='lowerback'>
        {_spine_triplet('lowerback', 'stiff_high')}
        <geom name='lowerback' size='0.065 0.055' pos='0 0.056 .03'
              quat='1 0 1 0'/>
        <body name='upperback' pos='0 0.1 -0.01'>
          {_spine_triplet('upperback', 'stiff_high')}
          <geom name='upperback' size='0.06 0.06' pos='0 0.06 0.02'
                quat='1 0 1 0'/>
          <body name='thorax' pos='0.000512528 0.11356 0.000936821'>
            {_spine_triplet('thorax', 'stiff_high')}
            <geom name='thorax' size='0.08 0.07' pos='0 0.05 0'
                  quat='1 0 1 0'/>
            <body name='lowerneck' pos='0 0.113945 0.00468037'>
              {_spine_triplet('lowerneck', 'stiff_medium')}
              <geom name='lowerneck' size='0.08 0.02' pos='0 0.04 -.02'
                    quat='1 1 0 0'/>
              <body name='upperneck' pos='0 0.09 0.01'>
                {_spine_triplet('upperneck', 'stiff_medium')}
                <geom name='upperneck' size='0.05 0.03' pos='0 0.05 0'
                      quat='.8 1 0 0'/>
                <body name='head' pos='0 0.09 0'>
                  {_spine_triplet('head', 'stiff_medium')}
                  <geom name='head' size='0.085 0.035' pos='0 0.11 0.03'
                        quat='1 .9 0 0'/>
                  <geom name='leye' type='sphere' size='0.02'
                        pos='.03 0.11 0.1'/>
                  <geom name='reye' type='sphere' size='0.02'
                        pos='-.03 0.11 0.1'/>
                </body>
              </body>
            </body>
            {_arm('l', 1)}
            {_arm('r', -1)}
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <contact>
    <exclude body1='lclavicle' body2='rclavicle'/>
    <exclude body1='lowerneck' body2='lclavicle'/>
    <exclude body1='lowerneck' body2='rclavicle'/>
    <exclude body1='upperneck' body2='lclavicle'/>
    <exclude body1='upperneck' body2='rclavicle'/>
  </contact>
  <actuator>{motors}
  </actuator>
</mujoco>
"""


class HumanoidCMU(base.Task):
    """Stand or move at a target speed (JAX humanoid_cmu.py HumanoidCMU)."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def __init__(self, move_speed: float):
        self._move_speed = move_speed

    def initialize_episode(self, model, batch, generator, attempts: int = 10):
        """Random configurations by lockstep rejection sampling:
        `attempts` draws an env (kinematics and detect only), the first
        without penetration over the pairs that
        ``opt.enable_geom_geom_contacts`` selects kept, else the last, as
        JAX's ``initialize_episode`` falls back."""
        q0 = model.qpos0.expand(attempts * batch, model.nq)
        qposes = randomizers.randomize_limited_and_rotational_joints(
            model, q0, generator)
        qpos = first_collision_free(
            model, qposes.reshape(attempts, batch, model.nq),
            fallback=-1,
            include_geom_geom=model.opt.enable_geom_geom_contacts)
        return make_state(model, qpos=qpos), ()

    def _com_velocity(self, model, data):
        thorax = model.name2id('body', 'thorax')
        return sensors.subtree_linvel(model, data, thorax)

    def _extremities(self, model, data):
        """Hands and feet relative to the thorax, in its frame (B, 12)."""
        thorax = model.name2id('body', 'thorax')
        ids = [model.name2id('body', side + limb)
               for side in ('l', 'r') for limb in ('hand', 'foot')]
        rel = data.xpos[:, ids] - data.xpos[:, thorax, None]
        return torch.einsum('bki,bij->bkj', rel,
                            data.ximat[:, thorax]).reshape(rel.shape[0], -1)

    def get_observation(self, model, phys, data):
        head = model.name2id('body', 'head')
        thorax = model.name2id('body', 'thorax')
        return {
            'joint_angles': phys.qpos[:, 7:],
            'head_height': data.xpos[:, head, 2],
            'extremities': self._extremities(model, data),
            'torso_vertical': data.ximat[:, thorax, 2],
            'com_velocity': self._com_velocity(model, data),
            'velocity': phys.qvel,
        }

    def get_reward(self, model, phys, data, ctrl):
        head = model.name2id('body', 'head')
        thorax = model.name2id('body', 'thorax')
        standing = rewards.tolerance(
            data.xpos[:, head, 2], bounds=(_STAND_HEIGHT, float('inf')),
            margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            data.ximat[:, thorax, 2, 1], bounds=(0.9, float('inf')),
            sigmoid='linear', margin=1.9, value_at_margin=0)
        stand_reward = standing * upright
        small_control = rewards.tolerance(
            ctrl, margin=1, value_at_margin=0, sigmoid='quadratic').mean(-1)
        small_control = (4 + small_control) / 5
        com_v = self._com_velocity(model, data)[:, :2]
        if self._move_speed == 0:
            dont_move = rewards.tolerance(com_v, margin=2).mean(-1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.vector_norm(com_v, dim=-1),
            bounds=(self._move_speed, float('inf')),
            margin=self._move_speed, value_at_margin=0, sigmoid='linear')
        move = (5 * move + 1) / 6
        return small_control * stand_reward * move


def _env(move_speed, time_limit, device, environment_kwargs):
    model = mjcf.parse(_make_xml()).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, HumanoidCMU(move_speed),
                               time_limit=time_limit, **kwargs)


@SUITE.add()
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    return _env(0, time_limit, device, environment_kwargs)


@SUITE.add()
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
        environment_kwargs=None):
    return _env(_RUN_SPEED, time_limit, device, environment_kwargs)
