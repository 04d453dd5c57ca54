"""Experiment CLI: config -> agent -> train.

Port of mujoco_mbrl_tpu/experiment.py with the same CONFIG_DEF and enums:

    python -m mujoco_mbrl_tpu_torch.experiment --exp_dir /tmp/exp \\
        --environment walker_walk --planner cem --model ens

plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the kernels). ``--environment`` takes the ported domains'
tasks through ``envs.load``: walker, cheetah, hopper (``hopper_stand``,
``hopper_hop``), reacher, point_mass, pendulum, cartpole
(``cartpole_balance``, ``cartpole_swingup``: the name splits at its last
underscore, as in the JAX CLI, so a task named with one is not reached),
swimmer (``swimmer_swimmer6``, ``swimmer_swimmer15``) and humanoid
(``humanoid_stand``, ``humanoid_walk``, ``humanoid_run``); acrobot has
no wrapper, as in the JAX package. Every
``--agent``, ``--planner`` and ``--model`` constructs as in the JAX CLI;
the combinations the JAX package cannot run fail where it fails (an
``RNNDynamics`` or ``RewardDynamics`` in a ``GoalStateAgent``, a model
without a reward head in a ``RewardAgent``, ``--planner ilqr``, an
ensemble planned per env when the plan dims divide by its size).
Defaults follow the JAX CLI: ``--agent gs --planner rs --model nn``,
horizon 20, rollout_length 200, 5 rollouts per iteration, 10 iterations,
Adam lr=0.01.
"""

from __future__ import annotations

import argparse
import json
import os
from enum import Enum
from typing import NamedTuple

from . import agents, envs, models, planners
from .device import resolve_device
from .models import train as Mt
from .utils import MetricsWriter, logger


class Planner(Enum):
    RandomShooting = 'rs'
    GradientDescent = 'grad'
    CEM = 'cem'
    ILQR = 'ilqr'

    def __str__(self):
        return self.value

    def construct(self):
        return {
            Planner.RandomShooting: planners.RandomShootingPlanner,
            Planner.GradientDescent: planners.GradientDescentPlanner,
            Planner.CEM: planners.CEMPlanner,
            Planner.ILQR: planners.ILQRPlanner,
        }[self]


class Model(Enum):
    NeuralNet = 'nn'
    Linear = 'lin'
    ModelWithReward = 'rw'
    Ensemble = 'ens'
    RNN = 'rnn'

    def __str__(self):
        return self.value

    def construct(self, environment: envs.EnvWrapper, plan_dim=None):
        od = plan_dim if plan_dim is not None else \
            environment.observation_dim
        ad = environment.action_dim
        if self is Model.NeuralNet:
            return models.MLPDynamics(od, ad)
        if self is Model.Linear:
            return models.LinearDynamics(od, ad)
        if self is Model.ModelWithReward:
            return models.RewardDynamics(od, ad, hidden_units=50)
        if self is Model.Ensemble:
            return models.EnsembleDynamics(models.MLPDynamics(od, ad),
                                           n_ensemble=5)
        return models.RNNDynamics(od, ad)


class Optimizer(Enum):
    Adam = 'adam'
    SGD = 'sgd'

    def __str__(self):
        return self.value

    def construct(self):
        """A factory over the parameter leaves (see models.train)."""
        if self is Optimizer.Adam:
            return Mt.adam(0.01)
        return Mt.sgd(0.1)


class Agent(Enum):
    GoalStateAgent = 'gs'
    RewardPredictingAgent = 'rw'

    def __str__(self):
        return self.value

    def construct(self, *, environment, planner, model, horizon, optimizer,
                  rollout_length, num_rollouts_per_iteration,
                  num_train_iterations, writer, base_path, seed,
                  planner_kwargs=None, train_epochs=50,
                  kernel_kwargs=None):
        common = dict(
            environment=environment, planner=planner, model=model,
            horizon=horizon, optimizer=optimizer,
            rollout_length=rollout_length,
            num_rollouts_per_iteration=num_rollouts_per_iteration,
            num_train_iterations=num_train_iterations, writer=writer,
            base_path=base_path, seed=seed, planner_kwargs=planner_kwargs,
            train_epochs=train_epochs, kernel_kwargs=kernel_kwargs)
        if self is Agent.GoalStateAgent:
            return agents.GoalStateAgent(
                action_cost=models.CoshLoss(),
                state_cost_weights=environment.get_goal_weights(),
                **common)
        return agents.RewardAgent(**common)


class EnvName(NamedTuple):
    env_name: str
    task_name: str

    def __str__(self):
        return f'{self.env_name}_{self.task_name}'


def Environment(v: str) -> EnvName:
    """`<env_name>_<task_name>`; loaded by ``main`` on its device."""
    try:
        env_name, task_name = v.rsplit('_', 1)
    except ValueError:
        raise argparse.ArgumentTypeError('<env_name>_<task_name>')
    return EnvName(env_name, task_name)


CONFIG_DEF = (
    ('--exp_dir', str, None, 'experiment output directory (required)'),
    ('--agent', Agent, Agent.GoalStateAgent, 'gs | rw'),
    ('--environment', Environment, None, 'e.g. reacher_easy'),
    ('--planner', Planner, Planner.RandomShooting, 'rs | grad | cem'),
    ('--model', Model, Model.NeuralNet, 'nn | lin | rw | ens | rnn'),
    ('--optimizer', Optimizer, Optimizer.Adam, 'adam | sgd'),
    ('--horizon', int, 20, 'planning horizon'),
    ('--rollout_length', int, 200, 'env steps per rollout'),
    ('--num_rollouts_per_iteration', int, 5, ''),
    ('--num_train_iterations', int, 10, ''),
    ('--train_epochs', int, 50, 'model-fit epochs per iteration'),
    ('--seed', int, 0, 'PRNG seed'),
    ('--log_level', str, 'info', 'debug | info | warning'),
    ('--planner_kwargs', str, '',
     'JSON overrides for the planner, e.g. \'{"num_candidates": 500}\''),
    ('--kernel_kwargs', str, '',
     'JSON options for the fused sampling kernel, e.g. '
     '\'{"sampler": "triangular"}\''),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    for name, typ, default, help_str in CONFIG_DEF:
        parser.add_argument(name, type=typ, default=default,
                            required=default is None, help=help_str)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(config, device=None) -> agents.MPCAgent:
    """Train the configured agent; ``device`` overrides ``config.device``
    (default ``cuda``)."""
    dev = resolve_device(device or getattr(config, 'device', None))
    os.makedirs(config.exp_dir, exist_ok=True)
    with open(os.path.join(config.exp_dir, 'config.txt'), 'w') as f:
        for k, v in sorted(vars(config).items()):
            f.write(f'{k}: {v}\n')
    logger.setup(os.path.join(config.exp_dir, 'experiment.log'),
                 config.log_level)

    environment = envs.load(*config.environment, device=dev)
    planner = config.planner.construct()
    # GoalStateAgent plans in the space the domain's goal lives in (the
    # featured state on locomotion domains); model dims must match.
    plan_dim = (int(environment.get_goal_weights().shape[0])
                if config.agent is Agent.GoalStateAgent else None)
    model = config.model.construct(environment, plan_dim=plan_dim)
    optimizer = config.optimizer.construct()
    planner_kwargs = (json.loads(config.planner_kwargs)
                      if config.planner_kwargs else None)
    kernel_kwargs = (json.loads(config.kernel_kwargs)
                     if config.kernel_kwargs else None)

    writer = MetricsWriter(config.exp_dir)
    try:
        agent = config.agent.construct(
            environment=environment, planner=planner, model=model,
            horizon=config.horizon, optimizer=optimizer,
            rollout_length=config.rollout_length,
            num_rollouts_per_iteration=config.num_rollouts_per_iteration,
            num_train_iterations=config.num_train_iterations,
            writer=writer, base_path=config.exp_dir, seed=config.seed,
            train_epochs=config.train_epochs,
            planner_kwargs=planner_kwargs, kernel_kwargs=kernel_kwargs)
        agent.train()
        agents.save(agent, os.path.join(config.exp_dir, 'agent_final'))
    finally:
        writer.close()
    return agent


if __name__ == '__main__':
    main(parse_args())
