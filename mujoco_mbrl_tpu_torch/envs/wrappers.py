"""MBRL env wrappers: featured state, goals, batched rollout collection.

Port of the EnvWrapper base and the Walker, Cheetah, Hopper, Reacher,
PointMass, Pendulum, Cartpole, Swimmer, Humanoid and Manipulator wrappers
of mujoco_mbrl_tpu/envs/wrappers.py. The
featured state's [qpos, qvel] part is nq + nv wide (the humanoid's free
root gives nq 28, nv 27). The JAX wrapper collects under
``vmap`` + ``lax.scan``; here the env batch is the leading dimension and
collection is a Python loop over control steps. Collection is two steps,
``reset`` and ``collect_from(env_state, ...)``, so a caller can start it
from given states. Randomness comes from a ``torch.Generator`` in place of
JAX keys.

Observation order. The JAX collectors flatten observation dicts in two
orders: a dict flattened inside the traced function keeps the task's key
order (orientations, height, velocity), one that crossed a ``vmap``
boundary first is in sorted pytree order (height, orientations,
velocity). ``get_rollouts_batched`` flattens its first observation in task
order (``_observe_full`` under ``vmap``) and every later one in sorted
order (``ts.observation`` returned by ``vmap(env.step_with_data)``); the
per-env collector ``rollout_fn`` (``get_rollouts``, random or with a
per-env policy) flattens inside its scan body, so all its observations
are in task order. ``collect_from`` reproduces both.

``get_rollouts`` (and its one-env form ``get_rollout`` / ``rollout_fn``,
a rollout with a leading axis of 1) takes the per-env policies
(``agents.MPCPolicy``) with the batched protocol: the port's policy plans
for all B envs in one call, each as JAX's vmapped one-env policy would.

``record_rollout`` collects one rollout, replays its actions from the
same reset and writes the replay as a GIF: camera 0 through the ray
caster where the model has a camera, else the orthographic rasterizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import suite as _suite
from ..data import Rollouts
from ..physics import engine
from ..physics.model import make_state
from ..suite import hopper as _hopper
from ..suite import manipulator as _manipulator
from ..suite import sensors
from ..suite.control import EnvState, flatten_observation
from ..utils import render as render_mod
from ..utils.raycast import Camera
from ..utils.recorder import Recorder


class EnvWrapper:
    """Adapts a suite Environment for the MBRL loop; the "state" vector is
    [qpos, qvel] unless a subclass feature-engineers it."""

    #: subclasses may force a control timestep
    override_control_timestep: Optional[float] = None

    def __init__(self, env: _suite.Environment, env_name: str,
                 task_name: str):
        self._env = env
        self._env_name = env_name
        self._task_name = task_name
        self._state_penalty = 1.0
        self.action_dim = env.model.nu
        self._action_spec = env.action_spec()
        ts_obs = env.observation_spec()
        self._obs_keys = list(ts_obs)              # the task's key order
        self.observation_dim = int(sum(np.prod(s.shape) or 1
                                       for s in ts_obs.values()))
        if getattr(self, 'state_dim', None) is None:
            self.state_dim = env.model.nq + env.model.nv

    @staticmethod
    def load(env_name: str, task_name: str, device=None,
             **kwargs) -> 'EnvWrapper':
        """The wrapper class for `env_name` around its suite env."""
        classname = ''.join(p.capitalize() for p in env_name.split('_'))
        wrapper_class = _WRAPPERS.get(classname)
        if wrapper_class is None:
            raise NotImplementedError(
                f'no ported wrapper for {env_name!r} '
                '(mujoco_mbrl_tpu.envs.wrappers.EnvWrapper.load)')
        env_kwargs = dict(kwargs.pop('environment_kwargs', {}) or {})
        if wrapper_class.override_control_timestep is not None:
            env_kwargs['control_timestep'] = (
                wrapper_class.override_control_timestep)
        # the remaining kwargs are the task's, as in JAX
        env = _suite.load(env_name, task_name, task_kwargs=kwargs or None,
                          environment_kwargs=env_kwargs or None,
                          device=device)
        return wrapper_class(env, env_name=env_name, task_name=task_name)

    @property
    def env(self) -> _suite.Environment:
        return self._env

    @property
    def device(self) -> torch.device:
        return self._env.model.device

    def action_spec(self):
        return self._action_spec

    def observation_spec(self):
        return self._env.observation_spec()

    # -- state featurization (identity by default) ----------------------
    def get_state(self, env_state: EnvState, data=None) -> torch.Tensor:
        """(B, state_dim): [qpos, qvel]."""
        return torch.cat([env_state.physics.qpos, env_state.physics.qvel], 1)

    def state_to_physics(self, state: torch.Tensor):
        """(qpos, qvel) of a [qpos, qvel] state (..., nq + nv)."""
        nq = self._env.model.nq
        return state[..., :nq], state[..., nq:]

    def _observe_full(self, env_state: EnvState
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(state (B, sd), obs (B, od)) for the current configuration, the
        observation flattened in the task's key order. The forward stops
        at the velocity stage when the task observes no acceleration: the
        JAX forward computes the constraint solve and XLA drops it as
        unused; run eagerly it would cost one APGD launch."""
        env = self._env
        m = env._model_with(env_state.params)
        phys = env_state.physics
        ctrl = torch.zeros((phys.qpos.shape[0], m.nu), dtype=phys.qpos.dtype,
                           device=phys.qpos.device)
        data = engine.forward(m, phys, ctrl, acc_stage=env._obs_acc)
        obs = env._task.get_observation(m, phys, data)
        return self.get_state(env_state, data), flatten_observation(obs)

    # -- sampling and goals ---------------------------------------------
    def sample_action(self, generator: torch.Generator,
                      batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniform in ctrlrange clipped to +-3, on the env's device."""
        lo = float(max(self._action_spec.minimum[0], -3))
        hi = float(min(self._action_spec.maximum[0], 3))
        u = torch.rand(tuple(batch_shape) + (self.action_dim,),
                       generator=generator, device=generator.device)
        return (lo + (hi - lo) * u).to(self.device)

    def _uniform(self, generator: torch.Generator, shape, lo, hi
                 ) -> torch.Tensor:
        """Uniform draws in [lo, hi) (bounds broadcast over the last axis
        of ``shape``), on the env's device."""
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
        hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
        return (lo + (hi - lo) * u).to(self.device)

    def sample_state(self, generator: torch.Generator,
                     batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError(
            f'{type(self).__name__}.sample_state is not ported '
            '(mujoco_mbrl_tpu.envs.wrappers)')

    def set_goal(self, generator: torch.Generator) -> torch.Tensor:
        """Sample a goal; returns the goal state vector."""
        raise NotImplementedError

    def apply_goal(self, env_state: EnvState,
                   goal_state: torch.Tensor) -> EnvState:
        """Write the goal into episode params. Default: no-op."""
        return env_state

    def get_goal_weights(self) -> torch.Tensor:
        return torch.zeros(self.state_dim, device=self.device)

    # -- rollout collection ---------------------------------------------
    def reset(self, num_rollouts: int, generator: torch.Generator,
              goal_state=None) -> EnvState:
        """`num_rollouts` new episodes with the goal applied."""
        env_state, _ = self._env.reset(num_rollouts, generator)
        if goal_state is not None:
            env_state = self.apply_goal(env_state, goal_state)
        return env_state

    def collect_from(self, env_state: EnvState, num_steps: int,
                     policy_batched: Callable, generator: torch.Generator,
                     policy_init: Optional[Callable] = None,
                     sorted_later_obs: bool = True) -> Rollouts:
        """Roll `num_steps` control steps from `env_state`.

        ``policy_batched(generator, t, state (B, sd), obs (B, od), carry)
        -> (actions (B, ad), carry)``. Observations after the first are
        flattened in sorted key order when ``sorted_later_obs`` (the JAX
        batched collector) and in the task's order otherwise (the JAX
        random collector); see the module docstring.
        """
        env = self._env
        s, o = self._observe_full(env_state)
        carry = policy_init() if policy_init is not None else 0
        states, obs, actions, rewards = [s], [o], [], []
        for t in range(num_steps):
            a, carry = policy_batched(generator, t, s, o, carry)
            env_state, ts, data = env.step_with_data(env_state, a)
            s = self.get_state(env_state, data)
            ob = ts.observation
            if not sorted_later_obs:
                ob = {k: ob[k] for k in self._obs_keys}
            o = flatten_observation(ob)
            states.append(s)
            obs.append(o)
            actions.append(a)
            rewards.append(ts.reward)
        return Rollouts(states=torch.stack(states, 1),
                        observations=torch.stack(obs, 1),
                        actions=torch.stack(actions, 1),
                        rewards=torch.stack(rewards, 1))

    def get_rollouts_batched(self, generator: torch.Generator,
                             num_rollouts: int, num_steps: int,
                             policy_batched: Callable, goal_state=None,
                             policy_init=None) -> Rollouts:
        """`num_rollouts` lockstep rollouts whose policy sees the whole
        env batch (the batched-planner collector)."""
        env_state = self.reset(num_rollouts, generator, goal_state)
        return self.collect_from(env_state, num_steps, policy_batched,
                                 generator, policy_init)

    def random_policy(self, generator, t, state, obs, carry):
        return self.sample_action(generator, (state.shape[0],)), carry

    def get_rollouts(self, generator: torch.Generator, num_rollouts: int,
                     num_steps: int, policy: Optional[Callable] = None,
                     goal_state=None, initial_states=None,
                     policy_init=None) -> Rollouts:
        """`num_rollouts` rollouts of ``policy`` (uniformly random actions
        when None), the per-env collector (wrappers.py:330-355): from
        ``initial_states`` (num_rollouts, nq + nv) when given, teleported
        in after the reset (``state_to_physics``), with ``goal_state``
        applied; ``goal_state`` may be one goal or one per env."""
        env_state = self.reset(num_rollouts, generator, goal_state)
        if initial_states is not None:
            phys = env_state.physics
            qpos, qvel = self.state_to_physics(initial_states.to(phys.qpos))
            env_state = dataclasses.replace(env_state, physics=(
                dataclasses.replace(phys, qpos=qpos.contiguous(),
                                    qvel=qvel.contiguous())))
        return self.collect_from(env_state, num_steps,
                                 policy or self.random_policy, generator,
                                 policy_init, sorted_later_obs=False)

    def rollout_fn(self, num_steps: int, policy: Optional[Callable] = None,
                   set_state: bool = False, policy_init=None) -> Callable:
        """``collect(generator, goal_state=None, initial_state=None) ->
        Rollouts`` of one env (JAX's single-env collector; ``set_state`` is
        accepted and unused, as there). The rollout has JAX's leading axis
        of 1 and T + 1 states and observations. ``policy`` keeps the
        port's batched protocol at B = 1: ``policy(generator, t, state (1,
        sd), obs (1, od), carry) -> (action (1, ad), carry)``; None draws
        uniformly random actions."""
        def collect(generator, goal_state=None, initial_state=None):
            return self.get_rollouts(
                generator, 1, num_steps, policy, goal_state=goal_state,
                initial_states=(None if initial_state is None
                                else initial_state.reshape(1, -1)),
                policy_init=policy_init)
        return collect

    def get_rollout(self, generator: torch.Generator, num_steps: int,
                    policy: Optional[Callable] = None, goal_state=None,
                    initial_state=None, policy_init=None) -> Rollouts:
        """One rollout (``rollout_fn``'s collector), from `initial_state`
        (nq + nv) when given."""
        return self.rollout_fn(num_steps, policy, policy_init=policy_init)(
            generator, goal_state, initial_state)

    def render_frames(self, qposes: torch.Tensor, params=(),
                      height: int = 128, width: int = 128,
                      plane: str = 'xz', extent: float = 2.5) -> np.ndarray:
        """(T, H, W, 3) uint8 frames of the configurations qposes (T, nq),
        rendered as one batch: through camera 0 (the ray caster) when the
        model has a camera, else through the orthographic rasterizer with
        the `plane` / `extent` framing."""
        m = self._env._model_with(params)
        state = make_state(m, qpos=qposes)
        data = engine.forward(m, state, torch.zeros(
            (qposes.shape[0], m.nu), dtype=qposes.dtype,
            device=qposes.device), acc_stage=False)
        if m.ncam > 0:
            imgs = Camera(m, height=height, width=width,
                          camera_id=0).render(data)
        else:
            imgs = render_mod.render(m, data, height, width, plane=plane,
                                     extent=extent)
        return render_mod.render_to_uint8(imgs)

    def record_rollout(self, generator: torch.Generator, num_steps: int,
                       policy: Optional[Callable] = None,
                       mp4path: Optional[str] = None,
                       goal_state=None, initial_state=None,
                       policy_init=None, height: int = 128,
                       width: int = 128, plane: str = 'xz',
                       extent: float = 2.5) -> Rollouts:
        """Collect one rollout and write it as a GIF (JAX
        envs/wrappers.py:198-273; the reference's mp4 of camera 0).

        The rollout's featured states need not hold qpos, so its physics
        is re-simulated: the reset is drawn again from a copy of
        ``generator``'s state taken before the rollout, and the recorded
        actions are replayed. One frame is rendered per replayed step,
        all of them as one batch after the run (``render_frames``), and
        written to ``<mp4path>.gif`` when a path is given.
        """
        replay = torch.Generator(device=generator.device)
        replay.set_state(generator.get_state())
        rolls = self.get_rollout(generator, num_steps, policy, goal_state,
                                 initial_state, policy_init)
        env_state = self.reset(1, replay, goal_state)
        if initial_state is not None:
            qpos, qvel = self.state_to_physics(
                initial_state.reshape(1, -1).to(env_state.physics.qpos))
            env_state = dataclasses.replace(env_state, physics=(
                dataclasses.replace(env_state.physics,
                                    qpos=qpos.contiguous(),
                                    qvel=qvel.contiguous())))
        qposes = []
        for a in rolls.actions[0]:
            env_state, _ = self._env.step(env_state, a[None])
            qposes.append(env_state.physics.qpos[0])
        frames = self.render_frames(torch.stack(qposes), env_state.params,
                                    height, width, plane, extent)
        rec = Recorder()
        for f in frames:
            rec.record_frame(f)
        if mp4path:
            rec.make_movie(mp4path)
        return rolls


class Walker(EnvWrapper):
    """Drop x, append upright / height / speed (wrappers.py:537-583)."""
    state_dim = 18 - 1 + 3
    observation_dim = 24

    def get_state(self, env_state, data=None):
        m = self._env.model
        phys = env_state.physics
        base = torch.cat([phys.qpos[:, 1:], phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 3))], 1)
        torso = m.name2id('body', 'torso')
        upright = data.ximat[:, torso, 2, 2]
        height = data.xpos[:, torso, 2]
        speed = sensors.subtree_linvel(m, data, torso)[:, 0]
        return torch.cat([base, upright[:, None], height[:, None],
                          speed[:, None]], 1)

    def sample_state(self, generator, batch_shape=()):
        """[qpos, qvel] (..., 18): the torso angle, the right leg's
        joints and the left's (its hip mirrors the right hip) drawn
        uniform in their ranges, the rest zero (wrappers.py:506-522)."""
        shape = tuple(batch_shape)
        u = self._uniform(generator, shape + (6,),
                          [-.1, -.15, -.3, -.1, -.3, -.1],
                          [.1, .15, 0., .1, 0., .1])
        st = torch.zeros(shape + (18,), device=self.device)
        st[..., 2:6] = u[..., :4]
        st[..., 6] = -u[..., 1]
        st[..., 7:9] = u[..., 4:]
        return st

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[-3:] = self._state_penalty
        return w

    def set_goal(self, generator=None):
        g = torch.zeros(self.state_dim, device=self.device)
        g[-3] = 1.0   # upright
        g[-2] = 1.3   # height
        g[-1] = 3.0   # speed
        return g


class Cheetah(EnvWrapper):
    """Drop x, append speed and torso height (wrappers.py:489-535)."""
    state_dim = 18 - 1 + 2
    observation_dim = 17
    # sample_state's uniform ranges of state[1:9] (rootz, rooty, the six
    # joints) and of the nine velocities
    _SAMPLE_RANGES = ((-.2, .2), (-3.14, 3.14), (-0.5236, 1.0472),
                      (-0.8727, 0.8727), (-4.0143, 0.8727),
                      (-0.9948, 0.0070), (-1.2217, 0.8727),
                      (-0.4887, 0.4887))

    def get_state(self, env_state, data=None):
        m = self._env.model
        phys = env_state.physics
        base = torch.cat([phys.qpos[:, 1:], phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 2))], 1)
        torso = m.name2id('body', 'torso')
        speed = sensors.subtree_linvel(m, data, torso)[:, 0]
        height = sensors.subtree_com(m, data, torso)[:, 2]
        return torch.cat([base, speed[:, None], height[:, None]], 1)

    def sample_state(self, generator, batch_shape=()):
        """[qpos, qvel] (..., 18): x zero, the rest uniform in
        ``_SAMPLE_RANGES`` and the velocities in [-3, 3) (wrappers.py:
        556-571)."""
        shape = tuple(batch_shape)
        lo, hi = zip(*self._SAMPLE_RANGES)
        st = torch.zeros(shape + (18,), device=self.device)
        st[..., 1:9] = self._uniform(generator, shape + (8,), lo, hi)
        st[..., 9:] = self._uniform(generator, shape + (9,), -3., 3.)
        return st

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[17] = self._state_penalty
        w[18] = self._state_penalty / 2.0
        return w

    def set_goal(self, generator=None):
        g = torch.zeros(self.state_dim, device=self.device)
        g[-2] = 2.0   # target speed
        g[-1] = 0.4   # target torso height
        return g


class PointMass(EnvWrapper):
    """The goal is the target xy (wrappers.py:356-383); planning runs on
    the observation [position, velocity]."""
    state_dim = 4
    observation_dim = 4

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[0:2] = 10 * self._state_penalty
        w[2:] = self._state_penalty / 4.0      # velocity damping
        return w

    def set_goal(self, generator):
        target = self._uniform(generator, (2,), -0.25, 0.25)
        return torch.cat([target, target.new_zeros(2)])

    def apply_goal(self, env_state, goal_state):
        """The env params carry the target xy (with the tendon directions
        on `hard`)."""
        B = env_state.physics.qpos.shape[0]
        target = goal_state[..., :2].expand(B, 2).to(
            env_state.physics.qpos.dtype)
        if isinstance(env_state.params, tuple):   # 'hard'
            params = (target, env_state.params[1])
        else:
            params = target
        return dataclasses.replace(env_state, params=params)

    def sample_state(self, generator, batch_shape=()):
        shape = tuple(batch_shape)
        return torch.cat([self._uniform(generator, shape + (2,), -0.29, 0.29),
                          self._uniform(generator, shape + (2,), -1.0, 1.0)],
                         -1)


class Reacher(EnvWrapper):
    """wrappers.py:386-448: a 0.04 s control step (2 physics substeps); the
    goal is a pose of the arm, and the target is put at its finger."""
    state_dim = 4
    observation_dim = 6
    override_control_timestep = 0.04

    def sample_state(self, generator, batch_shape=()):
        return self._uniform(generator, tuple(batch_shape) + (4,),
                             [-np.pi, -2.8, -3.0, -3.0],
                             [np.pi, 2.8, 3.0, 3.0])

    def get_goal_weights(self):
        w = torch.zeros(self.observation_dim, device=self.device)
        w[0:2] = self._state_penalty
        w[2:4] = self._state_penalty                # vector to the goal
        w[4:] = self._state_penalty / 20            # velocity damping
        return w

    def set_goal_state(self, generator, batch_shape=()):
        """Goal joint angles, zero velocity: (..., 4)."""
        angles = self._uniform(generator, tuple(batch_shape) + (2,),
                               [-np.pi, -2.8], [np.pi, 2.8])
        return torch.cat([angles, torch.zeros_like(angles)], -1)

    def set_goal(self, generator):
        g = torch.zeros(self.observation_dim, device=self.device)
        g[0:2] = self.set_goal_state(generator)[0:2]
        return g

    @staticmethod
    def goal_xy(goal_state: torch.Tensor) -> torch.Tensor:
        """(..., 2) finger position of the two-link arm at the goal angles
        goal_state[..., :2]."""
        a = 0.12 * torch.cos(goal_state[..., 1])
        b = 0.12 * torch.sin(goal_state[..., 1])
        theta = goal_state[..., 0] + torch.atan2(b, 0.12 + a)
        mag = torch.sqrt((0.12 + a) ** 2 + b ** 2)
        return torch.stack([mag * torch.cos(theta), mag * torch.sin(theta)],
                           -1)

    def apply_goal(self, env_state, goal_state):
        """The env params are the target xy: aim it at the arm pose that
        the goal joint angles describe."""
        B = env_state.physics.qpos.shape[0]
        xy = self.goal_xy(goal_state).expand(B, 2)
        return dataclasses.replace(
            env_state, params=xy.to(env_state.physics.qpos.dtype))

    def sample_rollouts_biased_rewards(self, generator,
                                       num_rollouts: int = 20,
                                       num_steps: int = 100) -> Rollouts:
        """Random rollouts whose arm starts on its own target, so they see
        reward (wrappers.py:435-447): each env's goal pose is both its
        initial state and its goal."""
        goals = self.set_goal_state(generator, (num_rollouts,))
        return self.get_rollouts(generator, num_rollouts, num_steps,
                                 goal_state=goals, initial_states=goals)


class Pendulum(EnvWrapper):
    """wrappers.py:475-487: the goal is the upright pole (zz = 1)."""
    state_dim = None

    def set_goal(self, generator=None):
        g = torch.zeros(self.observation_dim, device=self.device)
        g[0] = 1.0
        return g

    def get_goal_weights(self):
        w = torch.zeros(self.observation_dim, device=self.device)
        w[0:2] = self._state_penalty
        w[2:] = self._state_penalty / 20
        return w


class Cartpole(EnvWrapper):
    """wrappers.py:450-472: [qpos, qvel]; the goal is the upright pole at
    the centre, on the observation [x, zz, xz, velocities]."""
    state_dim = None

    def sample_state(self, generator, batch_shape=()):
        m, shape = self._env.model, tuple(batch_shape)
        return torch.cat([self._uniform(generator, shape + (m.nq,), -.5, .5),
                          self._uniform(generator, shape + (m.nv,), -1., 1.)],
                         -1)

    def set_goal(self, generator=None):
        g = torch.zeros(self.observation_dim, device=self.device)
        g[1] = 1.0
        return g

    def get_goal_weights(self):
        w = torch.zeros(self.observation_dim, device=self.device)
        w[0] = self._state_penalty / 2
        w[1:3] = self._state_penalty
        w[3:] = self._state_penalty / 20
        return w


class Hopper(EnvWrapper):
    """wrappers.py:586-630: drop x, append the log1p toe and heel touch,
    the torso's height over the foot and the torso subtree's speed."""
    state_dim = 14 - 1 + 4
    observation_dim = 15
    # sample_state's uniform ranges of state[2:7]
    _SAMPLE_RANGES = ((-.01, .01), (-.01, .01), (-.01, .01), (.1, .12),
                      (-.01, .01))

    def get_state(self, env_state, data=None):
        m = self._env.model
        phys = env_state.physics
        base = torch.cat([phys.qpos[:, 1:], phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 4))], 1)
        torso = m.name2id('body', 'torso')
        speed = sensors.subtree_linvel(m, data, torso)[:, 0]
        return torch.cat([base, _hopper.touch(m, data),
                          _hopper.height(m, data)[:, None], speed[:, None]],
                         1)

    def sample_state(self, generator, batch_shape=()):
        shape = tuple(batch_shape)
        lo, hi = zip(*self._SAMPLE_RANGES)
        st = torch.zeros(shape + (14,), device=self.device)
        st[..., 1] = -0.078789
        st[..., 2:7] = self._uniform(generator, shape + (5,), lo, hi)
        st[..., 7:] = self._uniform(generator, shape + (7,), -.01, .01)
        return st

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[-2] = self._state_penalty / 2.0
        w[-1] = self._state_penalty
        return w

    def set_goal(self, generator=None):
        g = torch.zeros(self.state_dim, device=self.device)
        g[-2] = 0.9   # height
        g[-1] = 1.0   # speed
        return g


class Swimmer(EnvWrapper):
    """wrappers.py:633-665: [qpos, qvel] and the head's orientation (the
    first row of its rotation, x and y)."""
    state_dim = None

    def __init__(self, env, env_name, task_name):
        self.state_dim = env.model.nq + env.model.nv + 2
        super().__init__(env, env_name, task_name)

    def get_state(self, env_state, data=None):
        phys = env_state.physics
        base = torch.cat([phys.qpos, phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 2))], 1)
        head = self._env.model.name2id('body', 'head')
        return torch.cat([base, data.ximat[:, head, 0, :2]], 1)

    def sample_state(self, generator, batch_shape=()):
        m, shape = self._env.model, tuple(batch_shape)
        st = torch.zeros(shape + (m.nq + m.nv,), device=self.device)
        st[..., 2] = self._uniform(generator, shape, -3.0, 3.0)
        return st

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[0:1] = 10 * self._state_penalty
        w[5:-2] = self._state_penalty
        return w

    def set_goal(self, generator):
        """A random target position (the task's own params carry the
        target geom's)."""
        g = torch.zeros(self.state_dim, device=self.device)
        g[0:2] = self._uniform(generator, (2,), -.5, .5)
        return g


class Humanoid(EnvWrapper):
    """wrappers.py:668-727: [qpos, qvel] and five Tassa-style features
    (feet-to-CoM, torso-to-CoM and torso-over-feet distances, CoM xy
    velocity), which the goal weights alone weigh."""
    state_dim = 55 + 5
    observation_dim = 67
    # the qpos0 the JAX sample_state draws around: height 1.3, the joint
    # ranges of the 21 hinges (radians, rounded as the JAX wrapper has
    # them); its root quaternion stays zero, as there
    _SAMPLE_RANGES = (
        (-0.7854, 0.7854), (-1.3089, 0.5236), (-0.6109, 0.6109),
        (-0.4363, 0.0873), (-1.0472, 0.6109), (-1.9199, 0.3491),
        (-2.7925, 0.0349), (-0.8727, 0.8727), (-0.8727, 0.8727),
        (-0.4363, 0.0873), (-1.0472, 0.6109), (-1.9199, 0.3491),
        (-2.7925, 0.0349), (-0.8727, 0.8727), (-0.8727, 0.8727),
        (-1.4835, 1.0472), (-1.4835, 1.0472), (-1.5708, 0.8727),
        (-1.0472, 1.4835), (-1.0472, 1.4835), (-1.5708, 0.8727))

    def get_state(self, env_state, data=None):
        m = self._env.model
        phys = env_state.physics
        base = torch.cat([phys.qpos, phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 5))], 1)
        torso = m.name2id('body', 'torso')
        rfoot = data.xpos[:, m.name2id('body', 'right_foot')]
        lfoot = data.xpos[:, m.name2id('body', 'left_foot')]
        com = sensors.subtree_com(m, data, torso)
        ave_foot = (rfoot + lfoot) / 2.0
        torso_pos = data.xpos[:, torso]
        above_feet = ave_foot[:, 1:] + torch.tensor(
            [0.0, 1.3], dtype=base.dtype, device=base.device)
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        p1 = norm(com[:, :2] - ave_foot[:, :2])
        p2 = norm(com[:, :2] - torso_pos[:, :2])
        p3 = norm(torso_pos[:, 1:] - above_feet)
        com_vel = sensors.subtree_linvel(m, data, torso)[:, :2]
        return torch.cat([base, p1, p2, p3, com_vel], 1)

    def sample_action(self, generator, batch_shape=()):
        """Normal torques (std 0.4) on the legs only: the abdomen's three
        and the arms' six motors get zero (wrappers.py:694-699)."""
        a = 0.4 * torch.randn(tuple(batch_shape) + (self.action_dim,),
                              generator=generator, device=generator.device)
        a[..., 3:-6] = 0.0
        return a.to(self.device)

    def sample_state(self, generator, batch_shape=()):
        shape = tuple(batch_shape)
        lo, hi = zip(*self._SAMPLE_RANGES)
        st = torch.zeros(shape + (55,), device=self.device)
        st[..., 2] = 1.3
        st[..., 7:28] = self._uniform(generator, shape + (21,), lo, hi)
        return st

    def state_to_physics(self, state):
        """(qpos, qvel) of a featured state: nq then nv wide."""
        m = self._env.model
        return state[..., :m.nq], state[..., m.nq:m.nq + m.nv]

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[-5:] = 10 * self._state_penalty
        return w

    def set_goal(self, generator=None):
        return torch.zeros(self.state_dim, device=self.device)


class Manipulator(EnvWrapper):
    """wrappers.py:729-768: [qpos, qvel], the grasp site's x and z and the
    five log1p touches (which read the observation forward's solve)."""
    state_dim = 22 + 7
    observation_dim = 37

    def get_state(self, env_state, data=None):
        m = self._env.model
        phys = env_state.physics
        base = torch.cat([phys.qpos, phys.qvel], 1)
        if data is None:
            return torch.cat([base, base.new_zeros((base.shape[0], 7))], 1)
        grasp = data.site_xpos[:, m.name2id('site', 'grasp')]
        return torch.cat([base, grasp[:, [0, 2]],
                          _manipulator.touch(m, data)], 1)

    def get_goal_weights(self):
        w = torch.zeros(self.state_dim, device=self.device)
        w[8:10] = 10 * self._state_penalty
        w[10:21] = self._state_penalty / 4
        w[-7:-5] = 10 * self._state_penalty
        w[-5:] = self._state_penalty / 20
        return w

    def set_goal(self, generator):
        """The ball over a random target (x, z) in [-0.4, 0.4), the grasp
        site on it, every touch at 0.5 (the task's own params carry the
        target body's pose)."""
        g = torch.zeros(self.state_dim, device=self.device)
        target = self._uniform(generator, (2,), -.4, .4)
        g[8:10] = target
        g[-7:-5] = target
        g[-5:] = 0.5
        return g


_WRAPPERS = {'Cartpole': Cartpole, 'Cheetah': Cheetah, 'Hopper': Hopper,
             'Humanoid': Humanoid, 'Manipulator': Manipulator,
             'Pendulum': Pendulum, 'PointMass': PointMass,
             'Reacher': Reacher, 'Swimmer': Swimmer, 'Walker': Walker}


def load(env_name: str, task_name: str, device=None,
         **kwargs) -> EnvWrapper:
    """Wrapped env on `device` (default ``cuda``)."""
    return EnvWrapper.load(env_name, task_name, device=device, **kwargs)
