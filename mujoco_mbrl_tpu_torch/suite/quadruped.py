"""Quadruped domain: walk / run / escape / fetch.

Port of mujoco_mbrl_tpu/suite/quadruped.py. ``_make_xml`` is this
package's own copy of the JAX module's (a test checks the three variants
are equal): filtered general actuators (``State.act``, one slot each),
fixed-tendon transmissions with four tendon-equality couplings, the
ellipsoid torso, condim-1 legs against a condim-3 floor, escape's
heightfield and fetch's condim-6 ball (priority 1, a direct solref) and
four tilted wall planes. The equality rows keep every solve dense: 240
rows on walk and run, 356 on escape, 914 on fetch, all on #1's global
path. The observation reads the IMU and the toes' force-torque sensors
from the forward's solve, so the task observes the acceleration stage.

The random draws (the reset quaternion, escape's bumps, fetch's azimuth,
spawn points and ball velocity) come from the caller's
``torch.Generator``. Escape's terrain is per env (B, 201, 201): the
bowl times uniform bumps resized by the Keys cubic (a = -0.5, half-pixel
centres, weights renormalised at the edges) that ``jax.image.resize(...,
'cubic')`` applies, as two weight-matrix products.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..physics import collision, make_state, mjcf, smooth
from ..physics import model as M
from . import base, control, rewards, sensors
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
_RUN_SPEED = 5
_WALK_SPEED = 0.5

_LEGS = ['front_left', 'front_right', 'back_right', 'back_left']
_LEG_EULER = {'front_left': '0 0 45', 'front_right': '0 0 -45',
              'back_right': '0 0 -135', 'back_left': '0 0 135'}
_LEG_POS = {'front_left': '.2 .2 0', 'front_right': '.2 -.2 0',
            'back_right': '-.2 -.2 0', 'back_left': '-.2 .2 0'}


def _leg_xml(leg: str) -> str:
    return f"""
      <body name='hip_{leg}' pos='{_LEG_POS[leg]}' euler='{_LEG_EULER[leg]}'
            childclass='hip'>
        <joint name='yaw_{leg}' class='yaw'/>
        <joint name='pitch_{leg}' class='pitch'/>
        <geom name='thigh_{leg}'/>
        <body name='knee_{leg}' pos='.3 0 .11' childclass='knee'>
          <joint name='knee_{leg}'/>
          <geom name='shin_{leg}'/>
          <body name='ankle_{leg}' pos='.25 0 -.25' childclass='ankle'>
            <joint name='ankle_{leg}'/>
            <geom name='foot_{leg}'/>
            <body name='toe_{leg}' pos='0 0 -.3' childclass='toe'>
              <geom name='toe_{leg}'/>
              <site name='toe_{leg}'/>
            </body>
          </body>
        </body>
      </body>"""


def _tendon_xml(leg: str) -> str:
    return f"""
    <fixed name='coupling_{leg}'>
      <joint joint='pitch_{leg}' coef='.333'/>
      <joint joint='knee_{leg}' coef='.333'/>
      <joint joint='ankle_{leg}' coef='.333'/>
    </fixed>
    <fixed name='extend_{leg}'>
      <joint joint='pitch_{leg}' coef='.25'/>
      <joint joint='knee_{leg}' coef='-.5'/>
      <joint joint='ankle_{leg}' coef='.25'/>
    </fixed>
    <fixed name='lift_{leg}'>
      <joint joint='pitch_{leg}' coef='.5'/>
      <joint joint='ankle_{leg}' coef='-.5'/>
    </fixed>"""


def _actuator_xml(leg: str) -> str:
    return f"""
    <general name='yaw_{leg}' class='yaw_act' joint='yaw_{leg}'/>
    <general name='lift_{leg}' class='lift_act' tendon='lift_{leg}'/>
    <general name='extend_{leg}' class='extend_act' tendon='extend_{leg}'/>"""


def _make_xml(floor_size: float, walls_and_ball: bool = False,
              terrain: bool = False) -> str:
    extras = ''
    asset = ''
    if terrain:
        asset = ("<asset><hfield name='terrain' nrow='201' ncol='201' "
                 "size='30 30 5 .1'/></asset>")
        extras += "\n    <geom name='terrain' type='hfield' pos='0 0 -.01'/>"
    extras_post = ''
    if walls_and_ball:
        # Wall positions/sizes are the quadruped.xml:78-81 literals (floor
        # size 15); the ball body comes AFTER the torso, matching the XML
        # body order (quadruped.xml:199) so the free-joint qpos layout is
        # [torso root, legs..., ball_root].
        fs = floor_size
        extras = f"""
    <geom name='wall_px' type='plane' pos='-{fs + .7} 0 .7'
          zaxis='1 0 1' size='1 {fs} .5'/>
    <geom name='wall_py' type='plane' pos='0 -{fs + .7} .7'
          zaxis='0 1 1' size='{fs} 1 .5'/>
    <geom name='wall_nx' type='plane' pos='{fs + .7} 0 .7'
          zaxis='-1 0 1' size='1 {fs} .5'/>
    <geom name='wall_ny' type='plane' pos='0 {fs + .7} .7'
          zaxis='0 -1 1' size='{fs} 1 .5'/>
    <site name='target' type='cylinder' size='.4 .06' pos='0 0 .05'/>"""
        extras_post = """
    <body name='ball' pos='0 0 3'>
      <freejoint name='ball_root'/>
      <geom name='ball' type='sphere' size='.15' priority='1' condim='6'
            friction='.7 .005 .005' density='1000' solref='-10000 -30'/>
    </body>"""
    legs = ''.join(_leg_xml(leg) for leg in _LEGS)
    tendons = ''.join(_tendon_xml(leg) for leg in _LEGS)
    actuators = ''.join(_actuator_xml(leg) for leg in _LEGS)
    couplings = ''.join(
        f"<tendon name='coupling_{leg}' tendon1='coupling_{leg}' "
        f"solimp='0.95 0.99 0.01' solref='.005 .5'/>" for leg in _LEGS)
    return f"""
<mujoco model='quadruped'>
  <option timestep='.005'/>
  {asset}
  <default>
    <geom solimp='.9 .99 .003' solref='.01 1'/>
    <general ctrllimited='true' gainprm='1000' biasprm='0 -1000'
             dyntype='filter' dynprm='.1'/>
    <default class='body'>
      <geom type='capsule' size='.08' condim='1' density='500'/>
      <joint type='hinge' damping='30' armature='.01' limited='true'
             solimplimit='0 .99 .01'/>
      <default class='hip'>
        <default class='yaw'>
          <joint axis='0 0 1' range='-50 50'/>
        </default>
        <default class='pitch'>
          <joint axis='0 1 0' range='-20 60'/>
        </default>
        <geom fromto='0 0 0 .3 0 .11'/>
      </default>
      <default class='knee'>
        <joint axis='0 1 0' range='-60 50'/>
        <geom size='.065' fromto='0 0 0 .25 0 -.25'/>
      </default>
      <default class='ankle'>
        <joint axis='0 1 0' range='-45 55'/>
        <geom size='.055' fromto='0 0 0 0 0 -.25'/>
      </default>
      <default class='toe'>
        <geom type='sphere' size='.08' friction='1.5'/>
        <site type='sphere' size='.084'/>
      </default>
    </default>
    <default class='yaw_act'>
      <general ctrlrange='-1 1'/>
    </default>
    <default class='lift_act'>
      <general ctrlrange='-1 1.1'/>
    </default>
    <default class='extend_act'>
      <general ctrlrange='-.8 .8'/>
    </default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' size='{floor_size} {floor_size} .5'/>
    {extras}
    <body name='torso' childclass='body' pos='0 0 .57'>
      <freejoint name='root'/>
      <site name='workspace' type='sphere' size='.3' pos='.8 0 -.2'/>
      <geom name='torso' type='ellipsoid' size='.3 .27 .2' density='1000'/>
      <site name='torso' type='sphere' size='.05'/>
      {legs}
    </body>
    {extras_post}
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <equality>{couplings}
  </equality>
  <actuator>{actuators}
  </actuator>
</mujoco>
"""


# ---- observation helpers (the reference's Physics methods) -------------


def _hinge_addrs(model):
    """qpos and dof addresses of the hinge joints (the legs')."""
    hinges = [j for j in range(model.njnt) if model.jnt_type[j] == M.HINGE]
    return ([model.jnt_qposadr[j] for j in hinges],
            [model.jnt_dofadr[j] for j in hinges])


def _common_observations(model, phys, data):
    qadr, dadr = _hinge_addrs(model)
    torso_site = model.name2id('site', 'torso')
    torso = model.name2id('body', 'torso')
    toes = [model.name2id('site', f'toe_{leg}') for leg in _LEGS]
    ft = torch.cat([sensors.force_site(model, data, s) for s in toes]
                   + [sensors.torque_site(model, data, s) for s in toes], 1)
    return {
        'egocentric_state': torch.cat([phys.qpos[:, qadr],
                                       phys.qvel[:, dadr], phys.act], 1),
        'torso_velocity': sensors.velocimeter(model, data, torso_site),
        'torso_upright': data.ximat[:, torso, 2, 2],
        'imu': torch.cat([
            sensors.accelerometer(model, data, phys.qvel, torso_site),
            sensors.gyro(model, data, torso_site)], 1),
        'force_torque': torch.asinh(ft),
    }


def _upright_reward(model, data, deviation_angle: float = 0.0):
    torso = model.name2id('body', 'torso')
    deviation = float(np.cos(np.deg2rad(deviation_angle)))
    return rewards.tolerance(
        data.ximat[:, torso, 2, 2], bounds=(deviation, float('inf')),
        sigmoid='linear', margin=1 + deviation, value_at_margin=0)


def _non_contacting_qpos(model, qpos):
    """The root lifted so no contact with the floor penetrates, plus 1 cm:
    the JAX closed form of the reference's 1 cm stepping search (raising
    the free root by dz raises every floor contact's distance by dz)."""
    kin = smooth.kinematics(model, qpos, smooth.tree_meta(model))
    floor = model.name2id('geom', 'floor')
    pairs = M.cached(model, 'floor_pairs', lambda: [
        p for p in collision.candidate_pairs(
            model, include_geom_geom=model.opt.enable_geom_geom_contacts)
        if floor in p])
    dist = collision.detect(model, kin[3], kin[4], pairs).dist
    out = qpos.clone()
    out[:, 2] = qpos[:, 2] + (torch.clamp(-dist.min(1).values, min=0.0)
                              + 0.01)
    return out


def _random_quat(model, batch, generator):
    q = torch.randn((batch, 4), generator=generator, dtype=model.dtype,
                    device=generator.device).to(model.device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def _uniform(model, shape, lo, hi, generator):
    u = torch.rand(shape, generator=generator, dtype=model.dtype,
                   device=generator.device).to(model.device)
    return lo + (hi - lo) * u


# ---- escape's terrain and rangefinder -----------------------------------

_TERRAIN_RES = 201          # hfield grid resolution (reference: 201)
_TERRAIN_SIZE = 30.0        # half-extent in meters (reference: 30)
_TERRAIN_SMOOTHNESS = 0.15
_TERRAIN_BUMP_SCALE = 2.0
_BUMP_RES = int(2 * _TERRAIN_SIZE / _TERRAIN_BUMP_SCALE)

# rangefinder rays: (from, to) endpoints in the torso frame, transcribed
# from the reference's rf_* site fromto values (ray = site +z = to-from)
_RF_ENDPOINTS = [
    ((.41, y, z0), (x1, 0.0, z1))
    for (z0, x1, z1) in ((.11, .34, .115), (.1, .36, .11),
                         (.09, .38, .105), (.08, .40, .10))
    for y in (-.02, -.01, 0.0, .01, .02)
]


def keys_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., 'cubic')`` along
    one axis (its ``compute_weight_mat`` when upsampling): Keys' cubic
    with a = -0.5 at half-pixel centres, each output's weights divided by
    their sum, zero for a sample outside the input. Float64."""
    sample = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = np.where(x >= 2.0, 0.0, np.where(
        x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
        ((1.5 * x - 2.5) * x) * x + 1.0))
    w = w / w.sum(0, keepdims=True)
    return np.where((sample >= -0.5) & (sample <= n_in - 0.5), w, 0.0)


def resize_cubic(bumps: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, n, n) -> (B, n_out, n_out): W' bumps W with ``keys_cubic_weights``
    (the JAX terrain's resize, as two products)."""
    W = torch.as_tensor(keys_cubic_weights(bumps.shape[-1], n_out),
                        dtype=bumps.dtype, device=bumps.device)
    return W.T @ bumps @ W


def terrain_bowl(dtype=torch.float32, device='cpu') -> torch.Tensor:
    """(res, res) sinusoidal bowl over the grid's radius r (clipped to
    [0.04, 1]): 0.5 - cos(2 pi r) / 2, a ring 1 high at r = 0.5."""
    grid = torch.linspace(-1.0, 1.0, _TERRAIN_RES, dtype=dtype,
                          device=device)
    radius = torch.clamp(torch.sqrt(grid[None, :] ** 2 + grid[:, None] ** 2),
                         0.04, 1.0)
    return 0.5 - torch.cos(2 * math.pi * radius) / 2.0


def generate_terrain(model, batch, generator) -> torch.Tensor:
    """(B, res, res) bowl times smooth bumps: uniform bumps in
    [smoothness, 1) on a 30 x 30 grid, resized to 201 x 201 (JAX
    ``_generate_terrain``; the reference's Escape init)."""
    bumps = _uniform(model, (batch, _BUMP_RES, _BUMP_RES),
                     _TERRAIN_SMOOTHNESS, 1.0, generator)
    return terrain_bowl(model.dtype, model.device) * resize_cubic(
        bumps, _TERRAIN_RES)


def _rangefinder(model, data, max_range=10.0, n_steps: int = 64):
    """(B, 20) ray readings against each env's terrain: the first of
    ``n_steps`` samples along a ray (the origin's ignored) below the
    surface, tanh of its distance, 1 where none is (JAX ``_rangefinder``;
    quadruped.py Physics.rangefinder)."""
    torso = model.name2id('body', 'torso')
    R, p0 = data.ximat[:, torso], data.xpos[:, torso]
    dt, dev = p0.dtype, p0.device
    frm = torch.tensor([e[0] for e in _RF_ENDPOINTS], dtype=dt, device=dev)
    to = torch.tensor([e[1] for e in _RF_ENDPOINTS], dtype=dt, device=dev)
    origin = p0[:, None] + torch.einsum('bij,rj->bri', R, frm)
    direction = torch.einsum('bij,rj->bri', R, to - frm)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    ts = torch.linspace(0.0, max_range, n_steps, dtype=dt, device=dev)
    pts = origin[:, :, None] + ts[:, None] * direction[:, :, None]
    hs = collision.hfield_height(model, pts[..., 0], pts[..., 1])
    below = pts[..., 2] < hs                              # (B, 20, n_steps)
    below[..., 0] = False                    # ignore the origin sample
    hit = below.any(-1)
    idx = torch.clamp(below.to(torch.int8).argmax(-1), min=1)
    reading = torch.where(hit, ts[idx], -1.0)
    return torch.where(reading == -1.0, 1.0, torch.tanh(reading))


# ---- the tasks ----------------------------------------------------------


class Move(base.Task):
    """Move forward at a desired speed (reference quadruped.py:317-358)."""

    def __init__(self, desired_speed: float):
        self._desired_speed = desired_speed

    def initialize_episode(self, model, batch, generator):
        qpos = model.qpos0.expand(batch, model.nq).clone()
        qpos[:, 0:3] = 0.0
        qpos[:, 3:7] = _random_quat(model, batch, generator)
        return make_state(model, qpos=_non_contacting_qpos(model, qpos)), ()

    def get_observation(self, model, phys, data):
        return _common_observations(model, phys, data)

    def get_reward(self, model, phys, data, ctrl):
        torso_site = model.name2id('site', 'torso')
        speed = sensors.velocimeter(model, data, torso_site)[:, 0]
        move_reward = rewards.tolerance(
            speed, bounds=(self._desired_speed, float('inf')),
            margin=self._desired_speed, value_at_margin=0.5,
            sigmoid='linear')
        return _upright_reward(model, data) * move_reward


class Escape(base.Task):
    """Escape the bowl-shaped terrain (quadruped.py:361-424). The params
    are each env's terrain (B, 201, 201), the model's ``hfield_data``."""

    def initialize_episode(self, model, batch, generator):
        terrain = generate_terrain(model, batch, generator)
        qpos = model.qpos0.expand(batch, model.nq).clone()
        qpos[:, 0:3] = 0.0
        qpos[:, 3:7] = _random_quat(model, batch, generator)
        return (make_state(model, qpos=_non_contacting_qpos(model, qpos)),
                terrain)

    def apply_params(self, model, params):
        return M.with_env_fields(model, hfield_data=params)

    def get_observation(self, model, phys, data):
        obs = _common_observations(model, phys, data)
        torso = model.name2id('body', 'torso')
        # the origin in the torso frame (Physics.origin)
        obs['origin'] = -torch.einsum('bi,bij->bj', data.xpos[:, torso],
                                      data.ximat[:, torso])
        obs['rangefinder'] = _rangefinder(model, data)
        return obs

    def get_reward(self, model, phys, data, ctrl):
        ws = model.name2id('site', 'workspace')
        escape_reward = rewards.tolerance(
            torch.linalg.vector_norm(data.site_xpos[:, ws], dim=-1),
            bounds=(_TERRAIN_SIZE, float('inf')), margin=_TERRAIN_SIZE,
            value_at_margin=0, sigmoid='linear')
        return _upright_reward(model, data,
                               deviation_angle=20) * escape_reward


class Fetch(base.Task):
    """Bring the ball to the target (reference quadruped.py:426-480)."""

    def __init__(self, floor_size: float):
        self._floor_size = floor_size

    def initialize_episode(self, model, batch, generator):
        azimuth = _uniform(model, (batch,), 0.0, 2 * math.pi, generator)
        spawn = 0.9 * self._floor_size
        xy = _uniform(model, (batch, 2), -spawn, spawn, generator)
        ball_xy = _uniform(model, (batch, 2), -spawn, spawn, generator)
        ball_v = 5.0 * torch.randn((batch, 2), generator=generator,
                                   dtype=model.dtype,
                                   device=generator.device).to(model.device)
        qpos = model.qpos0.expand(batch, model.nq).clone()
        qpos[:, 0:2] = xy
        qpos[:, 2] = 0.0
        zero = torch.zeros_like(azimuth)
        qpos[:, 3:7] = torch.stack([torch.cos(azimuth / 2), zero, zero,
                                    torch.sin(azimuth / 2)], 1)
        qpos = _non_contacting_qpos(model, qpos)
        ball = model.name2id('joint', 'ball_root')
        qa, da = model.jnt_qposadr[ball], model.jnt_dofadr[ball]
        qpos[:, qa:qa + 2] = ball_xy
        qpos[:, qa + 2] = 2.0
        qvel = torch.zeros((batch, model.nv), dtype=model.dtype,
                           device=model.device)
        qvel[:, da:da + 2] = ball_v
        return make_state(model, qpos=qpos, qvel=qvel), ()

    def get_observation(self, model, phys, data):
        obs = _common_observations(model, phys, data)
        torso = model.name2id('body', 'torso')
        ball = model.name2id('body', 'ball')
        frame = data.ximat[:, torso]
        bd = model.jnt_dofadr[model.name2id('joint', 'ball_root')]
        rd = model.jnt_dofadr[model.name2id('joint', 'root')]
        ball_state = torch.stack([
            data.xpos[:, ball] - data.xpos[:, torso],
            phys.qvel[:, bd:bd + 3] - phys.qvel[:, rd:rd + 3],
            phys.qvel[:, bd + 3:bd + 6]], 1) @ frame
        target = model.name2id('site', 'target')
        obs['ball_state'] = ball_state.reshape(-1, 9)
        obs['target_position'] = torch.einsum(
            'bi,bij->bj', data.site_xpos[:, target] - data.xpos[:, torso],
            frame)
        return obs

    def get_reward(self, model, phys, data, ctrl):
        arena_radius = self._floor_size * float(np.sqrt(2))
        workspace_radius, ball_radius, target_radius = 0.3, 0.15, 0.4
        ws = model.name2id('site', 'workspace')
        ball = model.name2id('body', 'ball')
        target = model.name2id('site', 'target')
        xy_norm = lambda v: torch.linalg.vector_norm(v[:, :2], dim=-1)
        reach_reward = rewards.tolerance(
            xy_norm(data.site_xpos[:, ws] - data.xpos[:, ball]),
            bounds=(0, workspace_radius + ball_radius), sigmoid='linear',
            margin=arena_radius, value_at_margin=0)
        fetch_reward = rewards.tolerance(
            xy_norm(data.site_xpos[:, target] - data.xpos[:, ball]),
            bounds=(0, target_radius), sigmoid='linear',
            margin=arena_radius, value_at_margin=0)
        reach_then_fetch = reach_reward * (0.5 + 0.5 * fetch_reward)
        return _upright_reward(model, data) * reach_then_fetch


def _env(task, xml, time_limit, device, environment_kwargs):
    # fetch's ball meets the legs through geom-geom pairs, which the
    # model's options enable by default, as in JAX
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(mjcf.parse(xml).to(device), task,
                               time_limit=time_limit, **kwargs)


@SUITE.add()
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    xml = _make_xml(floor_size=_DEFAULT_TIME_LIMIT * _WALK_SPEED)
    return _env(Move(_WALK_SPEED), xml, time_limit, device,
                environment_kwargs)


@SUITE.add()
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
        environment_kwargs=None):
    xml = _make_xml(floor_size=_DEFAULT_TIME_LIMIT * _RUN_SPEED)
    return _env(Move(_RUN_SPEED), xml, time_limit, device,
                environment_kwargs)


@SUITE.add()
def escape(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
           environment_kwargs=None):
    xml = _make_xml(floor_size=40, terrain=True)
    return _env(Escape(), xml, time_limit, device, environment_kwargs)


@SUITE.add()
def fetch(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    # the quadruped.xml default floor size of 15 (the reference's
    # make_model(walls_and_ball=True) with floor_size=None)
    xml = _make_xml(floor_size=15, walls_and_ball=True)
    return _env(Fetch(floor_size=15), xml, time_limit, device,
                environment_kwargs)
