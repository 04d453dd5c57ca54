"""MPC agents: the collect -> replay -> fit -> plan loop.

Port of mujoco_mbrl_tpu/agents/mpc.py: ``MPCPolicy``,
``BatchedMPCPolicy``, ``MPCAgent``, ``GoalStateAgent``, ``RewardAgent``
and ``save`` / ``load``.

``GoalStateAgent`` with ``CEMPlanner`` plans for the whole env batch in
one ``cem_batched`` call a control step (``BatchedMPCPolicy``), routed as
the JAX agent routes it: through the fused sampler
(``mlp_sample_rollout_costs``) for a plain ``MLPDynamics`` without output
noise, through the ensemble sampler (``mlp_sample_rollout_costs_ensemble``,
TS-infinity, candidate k -> member k % n) for an ``EnsembleDynamics`` over
such an MLP when the candidate count divides by its size, and through
``cem_batched``'s model / cost scan otherwise (a linear or noisy model,
an ensemble whose size does not divide the candidates). On CPU tensors
the kernels run their plain versions. Every other planner, and
``RewardAgent`` with any planner, plans per env through ``MPCPolicy``.

Randomness comes from one CPU ``torch.Generator`` seeded by ``seed`` (the
JAX agent's key); model weights and optimizer state live on the env's
device, and the model parameters are updated in place by the optimizer.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from .. import data as D
from .. import models as Mo
from ..envs import EnvWrapper
from ..models.train import make_normalizers, param_leaves, train_model
from ..ops.cem_rollout import (mlp_rollout_costs_t, mlp_sample_rollout_costs,
                               mlp_sample_rollout_costs_ensemble)
from ..planners import CEMPlanner, Trajectory, cem_batched
from ..utils import MetricsWriter, load_tree, logger, save_tree

# TPU layout knobs of the JAX kernels, dropped from kernel_kwargs
_TPU_KNOBS = ('envs_per_program', 'return_padded', 'unroll')


class MPCPolicy:
    """Warm-started receding-horizon policy over a per-env planner.

    ``policy(generator, t, state (B, sd), obs (B, od), carry) -> (actions
    (B, ad), carry)``: one ``planner.plan`` call a control step plans for
    every env, each as JAX's vmapped one-env policy would (agents/mpc.py:
    43-94). The carry holds the previous plan, invalidated at t == 0; the
    fallback warm start is zeros for CEM (its initial mean) and a
    ``sample_action`` draw for the other planners. Each call draws one
    seed from ``generator`` for a generator on the plan's device, from
    which the fallback and the planner draw.
    """

    def __init__(self, model: Callable, cost: Callable, planner,
                 sample_action: Callable, horizon: int, action_dim: int,
                 obs_dim: int, planner_kwargs: Optional[dict] = None,
                 plan_on_observations: bool = True):
        self.model = model
        self.cost = cost
        self.planner = planner
        self.sample_action = sample_action
        self.horizon = horizon
        self.action_dim = action_dim
        self.obs_dim = obs_dim
        self.planner_kwargs = planner_kwargs or {}
        self.plan_on_observations = plan_on_observations

    def init_carry(self):
        return (False, None)

    def __call__(self, generator, t, state_mat, obs_mat, carry):
        plan_vec = obs_mat if self.plan_on_observations else state_mat
        if plan_vec is None:
            # JAX's get_action passes no state, and a policy planning on
            # states then plans from None (agents/mpc.py:68-69, :525-531)
            raise AttributeError(
                "'NoneType' object has no attribute 'dtype': the policy "
                'plans on states and was given none, as JAX\'s '
                'GoalStateAgent.get_action gives a state-space policy')
        valid, last = carry
        B, H = plan_vec.shape[0], self.horizon
        g = torch.Generator(device=plan_vec.device).manual_seed(int(
            torch.randint(0, 2 ** 62, (), generator=generator)))
        if self.planner is CEMPlanner:
            fallback = plan_vec.new_zeros((B, H, self.action_dim))
        else:
            fallback = self.sample_action(g, (B, H))
        warm = last.actions if valid and t != 0 else fallback
        traj = self.planner.plan(
            plan_vec, self.model, self.cost, self.sample_action, H,
            initial_trajectory=Trajectory(
                states=None if last is None else last.states, actions=warm),
            generator=g, **self.planner_kwargs)
        return traj.actions[:, 0], (True, traj)


class BatchedMPCPolicy:
    """Whole-env-batch MPC policy over ``planners.cem_batched``.

    ``policy(generator, t, state (B, sd), obs (B, od), carry) ->
    (actions (B, ad), carry)``. The previous plan seeds the CEM mean; it
    is invalidated at t == 0. ``sample_costs_builder(obs) ->
    sample_costs_fn`` binds the planning states into the fused sampler;
    without one, ``rollout_costs_fn(s0T, actionsT)`` costs the candidates
    that ``cem_batched`` draws (JAX agents/mpc.py:150-152), and without
    that either, the scan of ``model(s (N, sd), a (N, ad))`` and
    ``cost(s, a)`` over all B K candidates does.
    """

    def __init__(self, horizon: int, action_dim: int,
                 planner_kwargs: Optional[dict] = None,
                 rollout_costs_fn: Optional[Callable] = None,
                 sample_costs_builder: Optional[Callable] = None,
                 plan_on_observations: bool = True,
                 model: Optional[Callable] = None,
                 cost: Optional[Callable] = None):
        if (sample_costs_builder is None and rollout_costs_fn is None
                and (model is None or cost is None)):
            raise ValueError('BatchedMPCPolicy needs a sample_costs_builder, '
                             'a rollout_costs_fn or a model and a cost')
        self.model = model
        self.cost = cost
        self.rollout_costs_fn = rollout_costs_fn
        cfg = {**CEMPlanner.defaults, **(planner_kwargs or {})}
        cfg.pop('action_dim', None)
        self.cfg = cfg
        self.horizon = horizon
        self.action_dim = action_dim
        self.sample_costs_builder = sample_costs_builder
        self.plan_on_observations = plan_on_observations

    def init_carry(self):
        return (False, None)

    def __call__(self, generator, t, state_mat, obs_mat, carry):
        plan_vec = obs_mat if self.plan_on_observations else state_mat
        valid, last_actions = carry
        init_mean = (last_actions.transpose(0, 1) if valid and t != 0
                     else None)
        seeds = torch.randint(0, 2 ** 31 - 1, (self.cfg['num_iterations'],),
                              generator=generator).tolist()
        scf = (self.sample_costs_builder(plan_vec)
               if self.sample_costs_builder is not None else None)
        traj = cem_batched(
            seeds, plan_vec, self.horizon, self.action_dim,
            num_candidates=self.cfg['num_candidates'],
            num_elites=self.cfg['num_elites'], init_mean=init_mean,
            action_low=self.cfg['action_low'],
            action_high=self.cfg['action_high'],
            rollout_costs_fn=None if scf is not None
            else self.rollout_costs_fn,
            sample_costs_fn=scf, model=self.model, cost=self.cost)
        return traj.actions[0], (True, traj.actions)


def save(agent: 'MPCAgent', path: str) -> None:
    """Checkpoint the agent's training state to ``<path>.pt``."""
    save_tree(path, agent.checkpoint_state())


def load(agent: 'MPCAgent', path: str) -> None:
    """Restore state saved by `save` into an identically-configured agent."""
    agent.restore_state(load_tree(path, map_location=agent.device))


class MPCAgent:
    """Outer-loop scaffolding: collection into the replay, metrics,
    model fitting, checkpoints."""

    def __init__(self, environment: EnvWrapper, planner, model,
                 horizon: int, optimizer: Callable, rollout_length: int,
                 num_rollouts_per_iteration: int, num_train_iterations: int,
                 writer: Optional[MetricsWriter], base_path: str,
                 dataset: Optional[D.ReplayBuffer] = None,
                 planner_kwargs: Optional[dict] = None,
                 train_epochs: int = 50, train_batch_size: int = 512,
                 num_initial_rollouts: int = 20, seed: int = 0,
                 kernel_kwargs: Optional[dict] = None):
        self.environment = environment
        self.device = environment.device
        self.planner = planner
        self.model = model
        self.horizon = horizon
        self.rollout_length = rollout_length
        self.num_rollouts_per_iteration = num_rollouts_per_iteration
        self.num_train_iterations = num_train_iterations
        self.writer = writer
        self.base_path = base_path
        self.planner_kwargs = planner_kwargs or {}
        # extra options of the fused sampler, e.g. {'sampler': 'spline4'}
        # or {'compute_dtype': torch.bfloat16}
        self.kernel_kwargs = kernel_kwargs or {}
        self.train_epochs = train_epochs
        self.train_batch_size = train_batch_size
        self.num_initial_rollouts = num_initial_rollouts

        self.generator = torch.Generator().manual_seed(seed)
        self.params = model.init(self.generator, device=self.device)
        # `optimizer` is a factory over the parameter leaves
        # (models.train.adam / sgd); it updates them in place
        self.optimizer = optimizer(param_leaves(self.params))
        self.train_iterations = 0
        self.obs_only = True

        if dataset is None:
            cap_rollouts = max(10000 // rollout_length, 1)
            dataset = D.init_replay(
                cap_rollouts, rollout_length,
                state_dim=environment.state_dim,
                obs_dim=environment.observation_dim,
                act_dim=environment.action_dim, device=self.device)
        self.dataset = dataset

    # ------------------------------------------------------------------
    def checkpoint_state(self):
        return {'params': self.params,
                'opt_state': self.optimizer.state_dict(),
                'dataset': D.replay.as_tree(self.dataset),
                'generator': self.generator.get_state(),
                'iter': self.train_iterations}

    def restore_state(self, state):
        with torch.no_grad():
            for dst, src in zip(param_leaves(self.params),
                                param_leaves(state['params'])):
                dst.copy_(src)
        self.optimizer.load_state_dict(state['opt_state'])
        self.dataset = D.replay.from_tree(state['dataset'], self.device)
        self.generator.set_state(state['generator'].cpu())
        self.train_iterations = int(state['iter'])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def add_rollouts(self, policy_collect=None, num_rollouts=None,
                     goal_state=None):
        """Collect rollouts (lockstep batch) and append to the replay."""
        rollout_type = 'policy' if policy_collect is not None else 'random'
        n = num_rollouts or self.num_rollouts_per_iteration
        logger.info('Generating %d %s rollouts of %d length.',
                    n, rollout_type, self.rollout_length)
        if policy_collect is not None:
            rolls = policy_collect(self.generator, goal_state)
        else:
            rolls = self.environment.get_rollouts(
                self.generator, n, self.rollout_length, policy=None,
                goal_state=goal_state)
        self.dataset = D.add_rollouts(self.dataset, rolls)
        self._record_metrics(rolls, rollout_type)
        return rolls

    def _record_metrics(self, rolls: D.Rollouts, rollout_type: str):
        if self.writer is None:
            return
        sums = rolls.sum_of_rewards().cpu().numpy()
        self.writer.add_scalar(f'AvgRolloutRewards/{rollout_type}',
                               sums.mean(), self.train_iterations)
        self.writer.add_histogram(f'RolloutRewards/{rollout_type}',
                                  sums, self.train_iterations)

    def _normalizers(self):
        return make_normalizers(self.dataset, use_observations=self.obs_only)

    def fit_model(self):
        """One model-fitting phase on the current replay buffer."""
        norms = self._normalizers()
        self.params, self.optimizer, log = train_model(
            self.model, self.params, self.dataset, self.generator,
            optimizer=self.optimizer, batch_size=self.train_batch_size,
            num_epochs=self.train_epochs, normalizers=norms,
            obs_only=self.obs_only)
        if self.writer is not None:
            losses = log.losses.cpu().numpy()
            for i in range(0, len(losses), max(len(losses) // 50, 1)):
                self.writer.add_scalar(
                    f'loss/state/{self.train_iterations}', losses[i], i)
        return log

    def train(self):
        raise NotImplementedError

    def get_action(self, generator, obs_vec):
        raise NotImplementedError


class GoalStateAgent(MPCAgent):
    """Cost = smooth-abs(state - goal) + cosh(action)."""

    def __init__(self, *, action_cost=None, state_cost_weights=None,
                 **kwargs):
        super().__init__(**kwargs)
        env = self.environment
        self.state_cost_weights = (
            state_cost_weights if state_cost_weights is not None
            else env.get_goal_weights()).to(self.device)
        self.action_cost_alpha = getattr(action_cost, 'alpha', 0.25)
        self.training_goal_state = None
        # plan in the space the goal lives in: the featured state on
        # locomotion domains, observations elsewhere
        goal_dim = int(self.state_cost_weights.shape[0])
        if goal_dim == env.observation_dim:
            self.obs_only = True
        elif goal_dim == env.state_dim:
            self.obs_only = False
        else:
            raise ValueError(
                f'goal weights dim {goal_dim} matches neither '
                f'observation_dim {env.observation_dim} nor state_dim '
                f'{env.state_dim} of {type(env).__name__}')
        self.plan_dim = goal_dim

    def _plan_model_fn(self, params, norms):
        """The model the planner rolls candidates through: an ensemble
        propagates TS-infinity (row k -> member k % n of the rows it is
        given). Called as JAX calls it, ``forward(params, s, a, norms)``:
        on an ``RNNDynamics`` that binds the normalizers to its hidden
        state and fails, as in JAX."""
        if isinstance(self.model, Mo.EnsembleDynamics):
            return lambda s, a: self.model.forward_ts(params, s, a, norms)
        return lambda s, a: self.model.forward(params, s, a, norms)

    def _cost(self, goal_state):
        weights, alpha = self.state_cost_weights, self.action_cost_alpha
        return lambda states, actions: (
            Mo.smooth_abs_loss(states, goal_state, weights)
            + Mo.cosh_loss(actions, alpha))

    def _make_policy(self, params, norms, goal_state):
        """The per-env policy (every planner but the batched CEM)."""
        env = self.environment
        return MPCPolicy(
            model=self._plan_model_fn(params, norms),
            cost=self._cost(goal_state), planner=self.planner,
            sample_action=env.sample_action, horizon=self.horizon,
            action_dim=env.action_dim, obs_dim=self.plan_dim,
            planner_kwargs=self.planner_kwargs,
            plan_on_observations=self.obs_only)

    def _sample_costs_builder(self, params, norms):
        """builder(plan_vec, goal) -> sample_costs_fn(seed, mean, std),
        bound to the fused sampler of the model family, or None where JAX
        plans on its scan (agents/mpc.py:398-457): the sampler for a plain
        ``MLPDynamics`` (not a subclass) without output noise, the
        ensemble sampler for an ensemble of those whose size divides the
        candidate count."""
        model = self.model
        is_ens = (isinstance(model, Mo.EnsembleDynamics)
                  and type(model.base) is Mo.MLPDynamics)
        if not ((is_ens or type(model) is Mo.MLPDynamics)
                and model.noise is None):
            return None
        K = {**CEMPlanner.defaults, **self.planner_kwargs}['num_candidates']
        kkw = {k: v for k, v in self.kernel_kwargs.items()
               if k not in _TPU_KNOBS}
        common = dict(normalizers=norms, alpha_action=self.action_cost_alpha,
                      num_candidates=K, **kkw)
        weights = self.state_cost_weights
        if is_ens:
            n = model.n
            if K % n:
                warnings.warn(
                    f'num_candidates={K} is not divisible by the {n}-member '
                    'ensemble: the TS-infinity sampler is disabled and '
                    'planning takes the (slower) model / cost scan, as in '
                    'JAX. Pick num_candidates as a multiple of the ensemble '
                    'size.', RuntimeWarning, stacklevel=2)
                return None
            return lambda obs, goal: (
                lambda seed, mean, std: mlp_sample_rollout_costs_ensemble(
                    params, seed, obs, mean, std, goal, weights,
                    n_members=n, **common))
        return lambda obs, goal: (
            lambda seed, mean, std: mlp_sample_rollout_costs(
                params, seed, obs, mean, std, goal, weights, **common))

    def _make_batched_policy(self, params, norms, goal_state):
        """Batched-CEM policy: over the fused sampler where the model
        family has one; for a plain ``MLPDynamics`` it also carries the
        non-fused rollout-cost kernel (JAX agents/mpc.py:376-380), which
        the policy takes only without a sampler builder; else the model /
        cost scan."""
        build = self._sample_costs_builder(params, norms)
        rc = None
        if type(self.model) is Mo.MLPDynamics and self.model.noise is None:
            rc = lambda s0T, aT: mlp_rollout_costs_t(
                params, s0T, aT, goal_state, self.state_cost_weights,
                normalizers=norms, alpha_action=self.action_cost_alpha)
        return BatchedMPCPolicy(
            horizon=self.horizon, action_dim=self.environment.action_dim,
            planner_kwargs=self.planner_kwargs, rollout_costs_fn=rc,
            sample_costs_builder=None if build is None else (
                lambda plan_vec: build(plan_vec, goal_state)),
            plan_on_observations=self.obs_only,
            model=self._plan_model_fn(params, norms),
            cost=self._cost(goal_state))

    def _policy_collect(self, n):
        """collect(params, norms, goal, generator) -> n MPC rollouts: the
        batched collector for CEM, the per-env one otherwise."""
        env = self.environment

        def collect(params, norms, goal, generator):
            if self.planner is CEMPlanner:
                policy = self._make_batched_policy(params, norms, goal)
                return env.get_rollouts_batched(
                    generator, n, self.rollout_length,
                    policy_batched=policy, goal_state=goal,
                    policy_init=policy.init_carry)
            policy = self._make_policy(params, norms, goal)
            return env.get_rollouts(
                generator, n, self.rollout_length, policy=policy,
                goal_state=goal, policy_init=policy.init_carry)
        return collect

    def _reset_goal(self):
        self.training_goal_state = self.environment.set_goal(self.generator)

    def _record_metrics(self, rolls, rollout_type):
        super()._record_metrics(rolls, rollout_type)
        if self.writer is None or self.training_goal_state is None:
            return
        vecs = rolls.observations if self.obs_only else rolls.states
        sc = Mo.smooth_abs_loss(vecs, self.training_goal_state,
                                self.state_cost_weights).sum(-1)
        ac = Mo.cosh_loss(rolls.actions, self.action_cost_alpha).sum(-1)
        for name, vals in [('State', sc), ('Action', ac),
                           ('Total', sc + ac)]:
            vals = vals.cpu().numpy()
            self.writer.add_scalar(f'AvgRollout{name}Costs/{rollout_type}',
                                   vals.mean(), self.train_iterations)
            self.writer.add_histogram(f'Rollout{name}Costs/{rollout_type}',
                                      vals, self.train_iterations)

    def train(self):
        """Seed rollouts -> [fit -> collect] x N."""
        logger.info('Starting outer training loop.')
        self._reset_goal()
        self.add_rollouts(num_rollouts=self.num_initial_rollouts,
                          goal_state=self.training_goal_state)
        for iteration in range(1, self.num_train_iterations + 1):
            logger.info('Iteration %d', iteration)
            self._reset_goal()
            self.train_iterations = iteration
            self.fit_model()
            norms = self._normalizers()
            collect = self._policy_collect(self.num_rollouts_per_iteration)
            self.add_rollouts(
                policy_collect=lambda generator, goal: collect(
                    self.params, norms, goal, generator),
                goal_state=self.training_goal_state)

    def get_action(self, generator, obs_vec, carry=None, t=0):
        """The per-env policy's action for ``obs_vec`` (od,) at step
        ``t``: (action (ad,), carry). As in JAX no state is passed, so an
        agent that plans on states fails here."""
        policy = self._make_policy(self.params, self._normalizers(),
                                   self.training_goal_state)
        return _one_env_action(policy, generator, obs_vec, carry, t)


def _one_env_action(policy, generator, obs_vec, carry, t):
    if carry is None:
        carry = policy.init_carry()
    with torch.no_grad():
        actions, carry = policy(generator, t, None, obs_vec[None], carry)
    return actions[0], carry


class RewardAgent(MPCAgent):
    """Plans against the learned reward head: the cost of (s_t, a_t) is
    the negated predicted reward of that transition (agents/mpc.py:534-
    589), always through the per-env ``MPCPolicy``, CEM included."""

    def _make_policy(self, params, norms):
        env = self.environment

        def model_fn(s, a):
            s_next, _ = self.model.forward(params, s, a, norms)
            return s_next

        def cost(states, actions):
            _, r = self.model.forward(params, states, actions, norms)
            return -r[..., 0]

        return MPCPolicy(
            model=model_fn, cost=cost, planner=self.planner,
            sample_action=env.sample_action, horizon=self.horizon,
            action_dim=env.action_dim, obs_dim=env.observation_dim,
            planner_kwargs=self.planner_kwargs)

    def _policy_collect(self, n):
        env = self.environment

        def collect(params, norms, generator):
            policy = self._make_policy(params, norms)
            return env.get_rollouts(generator, n, self.rollout_length,
                                    policy=policy,
                                    policy_init=policy.init_carry)
        return collect

    def train(self):
        """Seed rollouts -> [fit -> collect] x N."""
        logger.info('Starting outer training loop.')
        self.add_rollouts(num_rollouts=self.num_initial_rollouts)
        for iteration in range(1, self.num_train_iterations + 1):
            logger.info('Iteration %d', iteration)
            self.train_iterations = iteration
            self.fit_model()
            norms = self._normalizers()
            collect = self._policy_collect(self.num_rollouts_per_iteration)
            self.add_rollouts(
                policy_collect=lambda generator, goal: collect(
                    self.params, norms, generator))

    def get_action(self, generator, obs_vec, carry=None, t=0):
        """(action (ad,), carry) for the observation ``obs_vec`` (od,)."""
        policy = self._make_policy(self.params, self._normalizers())
        return _one_env_action(policy, generator, obs_vec, carry, t)
