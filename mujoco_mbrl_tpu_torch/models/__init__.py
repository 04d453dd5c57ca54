"""Dynamics models, planning costs and model fitting."""

from .costs import (CoshLoss, CostModel, QuadraticCost, SmoothAbsLoss,
                    cosh_loss, quadratic_cost, smooth_abs_loss,
                    state_action_cost)
from .dynamics import (EnsembleDynamics, LinearDynamics, MLPDynamics,
                       Normalizers, RewardDynamics, RNNDynamics)
from .train import TrainLog, evaluate_model, train_model

__all__ = ['CoshLoss', 'CostModel', 'EnsembleDynamics', 'LinearDynamics',
           'MLPDynamics', 'Normalizers', 'QuadraticCost', 'RNNDynamics',
           'RewardDynamics', 'SmoothAbsLoss', 'TrainLog', 'cosh_loss',
           'evaluate_model', 'quadratic_cost', 'smooth_abs_loss',
           'state_action_cost', 'train_model']
