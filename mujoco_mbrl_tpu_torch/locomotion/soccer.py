"""Soccer-lite: n-vs-n multi-agent ball game on a walled pitch, batched.

Port of mujoco_mbrl_tpu/locomotion/soccer.py, the functional redesign of
the reference's ``locomotion/soccer`` stack. The gameplay contract is the
reference's: per-player rewards of +1/-1 on a goal and 0 otherwise
(task.py:134-162), discount 0 and the episode's end when either goal
holds the ball (task.py:170-180), goal length 0.33x pitch width
(pitch.py:177-185), ball radius 0.35 / mass 0.045 (soccer_ball.py:42),
and a randomized kickoff (task.py:115-121). As in the JAX package,
``size=(12, 9)`` is the *full* pitch (a half-scale redesign), goal
sensing is a pure function of the ball's position against the goal
mouths, players are planar thruster boxes ("boxhead-lite", 3 actions
each), possession statistics are instantaneous observables, and the
walls enclose the pitch.

The goal posts are cylinders. Neither package has a cylinder pair
kernel (the JAX collision table has none), so the posts collide with
nothing; the port keeps that. ``RandomizedPitch`` moves the walls and
posts of each env through per-env ``geom_pos`` (``with_env_fields``),
which the kinematics and the plane contacts read.

``load(team_size)`` mirrors ``soccer/__init__.py:64`` and returns the
batched environment on ``cuda`` unless ``device='cpu'``; the action is
the concatenated (B, 3 * 2n) thruster vector, the reward (B, 2n).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import composer
from ..physics import builder
from ..physics import model as M

_PITCH_SIZE = (12.0, 9.0)       # pitch.py:37 _DEFAULT_PITCH_SIZE
_GOAL_LENGTH_RATIO = 0.33       # pitch.py:38 goal length / pitch width
_BALL_RADIUS = 0.35             # soccer_ball.py:42
_BALL_MASS = 0.045
_RGBA_HOME = [0.1, 0.1, 0.8, 1.0]
_RGBA_AWAY = [0.8, 0.1, 0.1, 1.0]


class Pitch(composer.Entity):
    """Walled soccer pitch; goals are +x (away's) and -x (home's), their
    mouths static rectangles the task tests the ball against, with posts
    as geoms."""

    def _build(self, size=_PITCH_SIZE, goal_size=None, wall_height=2.0,
               timestep=0.005):
        self.size = size
        half_len, half_wid = size[0] / 2, size[1] / 2
        # (depth, half-length-of-mouth, height) as pitch.py:177-185
        self.goal_size = goal_size or (0.5, size[1] * _GOAL_LENGTH_RATIO / 2,
                                       0.5)
        root = builder.RootElement(model='pitch')
        root.option(timestep=timestep)
        wb = root.worldbody
        wb.add('geom', name='field', type='plane',
               size=[half_len + 1, half_wid + 1, 0.1], friction=[0.7])
        for name, pos, zaxis, sz in (
                ('wall_px', [half_len + 1, 0, wall_height / 2],
                 [-1, 0, 0], [half_wid + 1, wall_height, 0.1]),
                ('wall_nx', [-half_len - 1, 0, wall_height / 2],
                 [1, 0, 0], [half_wid + 1, wall_height, 0.1]),
                ('wall_py', [0, half_wid + 1, wall_height / 2],
                 [0, -1, 0], [half_len + 1, wall_height, 0.1]),
                ('wall_ny', [0, -half_wid - 1, wall_height / 2],
                 [0, 1, 0], [half_len + 1, wall_height, 0.1])):
            wb.add('geom', name=name, type='plane', pos=pos, zaxis=zaxis,
                   size=sz)
        gd, gw, gh = self.goal_size
        for side, sx in (('home', -1.0), ('away', 1.0)):
            for post, py in ((f'{side}_post_n', -gw), (f'{side}_post_p', gw)):
                wb.add('geom', name=post, type='cylinder', size=[0.08],
                       fromto=[sx * half_len, py, 0, sx * half_len, py, gh])
        return root

    def goal_rect(self, side: str):
        """(x_lo, x_hi, y_half) of `side`'s goal mouth in world frame
        (the build-time geometry; episode overrides read the model)."""
        half_len = self.size[0] / 2
        gd, gw, _ = self.goal_size
        if side == 'home':
            return (-half_len - gd, -half_len, gw)
        return (half_len, half_len + gd, gw)

    def goal_rect_in(self, model, side: str):
        """Goal mouth from the (possibly per-env) model: the posts carry
        the goal line x and the mouth's half-width y, each a scalar
        tensor or (B,)."""
        g = model.names['geom'][f'{side}_post_p']
        x_line = model.geom_pos[..., g, 0]
        y_half = torch.abs(model.geom_pos[..., g, 1])
        sign = -1.0 if side == 'home' else 1.0
        return x_line, x_line + sign * self.goal_size[0], y_half

    def episode_size(self, params):
        """(length, width) for this episode; fixed pitches ignore params."""
        return self.size


class RandomizedPitch(Pitch):
    """Pitch whose size is re-sampled every episode (pitch.py:220
    RandomizedPitch): the scene is built once at ``max_size`` and each
    env's size moves its walls and posts (``apply_params``); goal sensing
    reads the moved posts."""

    def _build(self, min_size=(6.0, 4.0), max_size=_PITCH_SIZE,
               keep_aspect_ratio=False, **kwargs):
        self.min_size = min_size
        self.max_size = max_size
        self.keep_aspect_ratio = keep_aspect_ratio
        return super()._build(size=max_size, **kwargs)

    def initialize_episode(self, model, batch, generator):
        """(B, 2) size ratios in [0, 1)."""
        ratios = torch.rand((batch, 2), generator=generator,
                            device=generator.device).to(model.device,
                                                        model.dtype)
        if self.keep_aspect_ratio:  # pitch.py:275-281
            ratios = ratios[:, :1].expand(batch, 2).clone()
        return ratios

    def episode_size(self, params):
        lo = torch.as_tensor(self.min_size, dtype=params.dtype,
                             device=params.device)
        hi = torch.as_tensor(self.max_size, dtype=params.dtype,
                             device=params.device)
        size = lo + params * (hi - lo)  # pitch.py:282
        return size[:, 0], size[:, 1]

    def apply_params(self, model, params):
        length, width = self.episode_size(params)
        half_len, half_wid = length / 2, width / 2
        gw = width * _GOAL_LENGTH_RATIO / 2
        gp = model.geom_pos.expand(
            (params.shape[0],) + tuple(model.geom_pos.shape[-2:])).clone()
        names = model.names['geom']
        for name, x, y in (('wall_px', half_len + 1, None),
                           ('wall_nx', -half_len - 1, None),
                           ('wall_py', None, half_wid + 1),
                           ('wall_ny', None, -half_wid - 1),
                           ('home_post_n', -half_len, -gw),
                           ('home_post_p', -half_len, gw),
                           ('away_post_n', half_len, -gw),
                           ('away_post_p', half_len, gw)):
            g = names[name]
            if x is not None:
                gp[:, g, 0] = x
            if y is not None:
                gp[:, g, 1] = y
        return M.with_env_fields(model, geom_pos=gp)


class SoccerBall(composer.Entity):
    """Free sphere with the reference ball's radius / mass
    (soccer_ball.py:42)."""

    def _build(self, radius=_BALL_RADIUS, mass=_BALL_MASS):
        self.radius = radius
        root = builder.RootElement(model='soccer_ball')
        body = root.worldbody.add('body', name='ball', pos=[0, 0, radius])
        body.add('joint', name='root', type='free')
        body.add('geom', name='ball', type='sphere', size=[radius],
                 mass=mass, friction=[0.7])
        return root

    def body_id(self, model):
        return model.names['body'][self.name('ball')]

    def dof_adr(self, model):
        return int(model.jnt_dofadr[model.names['joint'][self.name('root')]])

    def qpos_adr(self, model):
        return int(model.jnt_qposadr[model.names['joint'][self.name('root')]])

    @composer.observable
    def position(self, model, phys, data):
        return data.xpos[:, self.body_id(model)]

    @composer.observable
    def velocity(self, model, phys, data):
        d = self.dof_adr(model)
        return phys.qvel[:, d:d + 3]


class BoxHead(composer.Entity):
    """Boxhead-lite player: a marked box with a head sphere, driven by
    planar thrusters (slide x / y motors) and a yaw spinner (the role of
    the reference BoxHead, boxhead.py:108)."""

    def _build(self, marker_rgba=None, box_size=0.2, gear=8.0):
        root = builder.RootElement(model='boxhead')
        body = root.worldbody.add('body', name='root',
                                  pos=[0, 0, box_size])
        body.add('joint', name='root_x', type='slide', axis=[1, 0, 0],
                 limited=False, damping=2.0)
        body.add('joint', name='root_y', type='slide', axis=[0, 1, 0],
                 limited=False, damping=2.0)
        body.add('joint', name='steer', type='hinge', axis=[0, 0, 1],
                 limited=False, damping=0.5)
        kw = {'rgba': marker_rgba} if marker_rgba else {}
        body.add('geom', name='torso', type='box',
                 size=[box_size, box_size, box_size], mass=3.0,
                 friction=[0.7], **kw)
        body.add('geom', name='head', type='sphere', size=[box_size / 2],
                 pos=[box_size, 0, box_size], mass=0.1, **kw)
        for j, g in (('root_x', gear), ('root_y', gear), ('steer', 2.0)):
            root.actuator.add('motor', name=j, joint=j, gear=g,
                              ctrllimited=True, ctrlrange=[-1, 1])
        return root

    def body_id(self, model):
        return model.names['body'][self.name('root')]

    def _adr(self, model, joint):
        j = model.names['joint'][self.name(joint)]
        return int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])

    def root_xy(self, model, phys, data):
        return data.xpos[:, self.body_id(model), :2]

    def yaw(self, model, phys, data):
        return phys.qpos[:, self._adr(model, 'steer')[0]]

    @composer.observable
    def velocity(self, model, phys, data):
        return phys.qvel[:, [self._adr(model, j)[1]
                             for j in ('root_x', 'root_y', 'steer')]]

    @composer.observable
    def orientation(self, model, phys, data):
        yaw = self.yaw(model, phys, data)
        return torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)


class Soccer(composer.Task):
    """n-vs-n soccer (soccer/task.py Task): players 0..n-1 are HOME
    (defend -x, score at +x), n..2n-1 are AWAY."""

    control_timestep = 0.025
    OBSERVES_ACC = False

    def __init__(self, team_size: int = 1, pitch: Pitch = None,
                 spawn_margin: float = 1.0):
        if not 1 <= team_size <= 11:
            raise ValueError('team_size must be within [1, 11]: '
                             f'{team_size}')  # soccer/__init__.py:85
        pitch = pitch or Pitch()
        super().__init__(pitch)
        self.pitch = pitch
        self.team_size = team_size
        self.ball = self.attach(SoccerBall(), 'ball/')
        self.players = []
        for team, rgba in (('home', _RGBA_HOME), ('away', _RGBA_AWAY)):
            for i in range(team_size):
                self.players.append(self.attach(
                    BoxHead(marker_rgba=rgba), f'{team}{i}/'))
        # +1 for HOME players, -1 for AWAY: HOME scores in the away goal
        self._team_sign = np.concatenate([np.ones(team_size),
                                          -np.ones(team_size)])
        self._spawn_margin = spawn_margin

    def _sign(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._team_sign, dtype=like.dtype,
                               device=like.device)

    # -- kickoff (task.py:115-121 throw-in + UniformInitializer) ----------
    def initialize_episode(self, model, batch, generator):
        """The ball near the centre spot, resting on the field; players
        uniform in their own half of each env's pitch, random heading."""
        state = M.make_state(model, batch=batch)
        uniform = lambda shape, lo, hi: (lo + (hi - lo) * torch.rand(
            shape, generator=generator, device=generator.device)).to(
                model.device, model.dtype)
        # the pitch's episode params first (RandomizedPitch's size): the
        # spawns below use this episode's extents
        pitch_params = self.pitch.initialize_episode(model, batch, generator)
        length, width = self.pitch.episode_size(pitch_params)
        qpos = state.qpos.clone()
        ba = self.ball.qpos_adr(model)
        qpos[:, ba:ba + 2] = uniform((batch, 2), -1.0, 1.0)
        qpos[:, ba + 2] = self.ball.radius
        half_len = torch.as_tensor(length, dtype=qpos.dtype,
                                   device=qpos.device) / 2 - self._spawn_margin
        half_wid = torch.as_tensor(width, dtype=qpos.dtype,
                                   device=qpos.device) / 2 - self._spawn_margin
        n = len(self.players)
        u = uniform((batch, n, 2), -1.0, 1.0)
        # own half: HOME x in [-half_len, 0), AWAY x in (0, half_len]
        own = -self._sign(qpos)
        x = own * (1.0 + u[..., 0]) * half_len.reshape(-1, 1) / 2
        y = u[..., 1] * half_wid.reshape(-1, 1)
        yaws = uniform((batch, n), -math.pi, math.pi)
        for i, p in enumerate(self.players):
            qpos[:, p._adr(model, 'root_x')[0]] = x[:, i]
            qpos[:, p._adr(model, 'root_y')[0]] = y[:, i]
            qpos[:, p._adr(model, 'steer')[0]] = yaws[:, i]
        # params aligned with self._entities: (pitch, ball, *players)
        params = (pitch_params,) + ((),) * (len(self._entities) - 1)
        return state.replace(qpos=qpos), params

    # -- goal sensing (pitch.py:192-201, pure) -----------------------------
    def _ball_xy(self, model, phys, data):
        return data.xpos[:, self.ball.body_id(model), :2]

    def _in_goal(self, model, xy, side):
        x_line, x_back, y_half = self.pitch.goal_rect_in(model, side)
        x_lo = torch.minimum(x_line, x_back)
        x_hi = torch.maximum(x_line, x_back)
        return ((xy[:, 0] >= x_lo) & (xy[:, 0] <= x_hi)
                & (torch.abs(xy[:, 1]) <= y_half))

    def scored(self, model, phys, data):
        """(B,): +1 where HOME scored (ball in the away goal), -1 where
        AWAY did, 0 otherwise (``detected_goal``, pitch.py:192)."""
        xy = self._ball_xy(model, phys, data)
        return (self._in_goal(model, xy, 'away').to(torch.float32)
                - self._in_goal(model, xy, 'home').to(torch.float32))

    # -- rewards / termination (task.py:134-180) ---------------------------
    def get_reward(self, model, phys, data, ctrl):
        """(B, 2n) per-player rewards: +1 scored / -1 conceded / 0."""
        s = self.scored(model, phys, data)
        return s[:, None] * self._sign(s)

    def get_termination(self, model, phys, data):
        goal = self.scored(model, phys, data) != 0
        return goal, torch.zeros(goal.shape, dtype=phys.qpos.dtype,
                                 device=goal.device)

    # -- per-player egocentric observables ---------------------------------
    # (observables.py CoreObservablesAdder: ball / goals / team-mates /
    # opponents in each player's frame, yaw-rotated)
    def _ego(self, p, model, phys, data, world_xy):
        """world_xy (B, 2) or (B, k, 2) in player p's yaw frame."""
        yaw = p.yaw(model, phys, data)
        root = p.root_xy(model, phys, data)
        if world_xy.dim() == 3:
            root, yaw = root[:, None], yaw[:, None]
        d = world_xy - root
        c, s = torch.cos(yaw), torch.sin(yaw)
        return torch.stack([c * d[..., 0] + s * d[..., 1],
                            -s * d[..., 0] + c * d[..., 1]], -1)

    def observables(self):
        out = dict(super().observables())

        def ego_ball(p):
            def fn(model, phys, data):
                return self._ego(p, model, phys, data,
                                 self._ball_xy(model, phys, data))
            return fn

        def ego_goal(p, side):
            def fn(model, phys, data):
                x_line, x_back, _ = self.pitch.goal_rect_in(model, side)
                cx = ((x_line + x_back) / 2).expand(phys.qpos.shape[0])
                center = torch.stack([cx, torch.zeros_like(cx)], -1)
                return self._ego(p, model, phys, data, center)
            return fn

        def ego_others(p, others):
            def fn(model, phys, data):
                xy = torch.stack([o.root_xy(model, phys, data)
                                  for o in others], 1)
                ego = self._ego(p, model, phys, data, xy)
                return ego.reshape(ego.shape[0], -1)
            return fn

        n = self.team_size
        for i, p in enumerate(self.players):
            own = 'home' if i < n else 'away'
            opp = 'away' if i < n else 'home'
            mates = [q for j, q in enumerate(self.players)
                     if j != i and (j < n) == (i < n)]
            opps = [q for j, q in enumerate(self.players)
                    if (j < n) != (i < n)]
            out[p.prefix + 'ball_ego'] = ego_ball(p)
            out[p.prefix + 'own_goal_ego'] = ego_goal(p, own)
            out[p.prefix + 'opponent_goal_ego'] = ego_goal(p, opp)
            if mates:
                out[p.prefix + 'teammates_ego'] = ego_others(p, mates)
            out[p.prefix + 'opponents_ego'] = ego_others(p, opps)
        return out

    # -- possession stats (soccer_ball.py trackers, instantaneous) ---------
    @composer.observable
    def stats_ball_distances(self, model, phys, data):
        ball = self._ball_xy(model, phys, data)
        xy = torch.stack([p.root_xy(model, phys, data)
                          for p in self.players], 1)
        return torch.linalg.vector_norm(xy - ball[:, None], dim=-1)

    @composer.observable
    def stats_possession(self, model, phys, data):
        d = self.stats_ball_distances(model, phys, data)
        return torch.nn.functional.one_hot(
            torch.argmin(d, dim=-1), len(self.players)).to(d.dtype)


def load(team_size: int = 1, time_limit: float = 45.0, device=None,
         **task_kwargs):
    """n-vs-n soccer environment (soccer/__init__.py:64 load) on
    `device` (default ``cuda``)."""
    task = Soccer(team_size=team_size, **task_kwargs)
    return composer.make_env(task, time_limit=time_limit, device=device)
