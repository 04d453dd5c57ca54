"""Dynamics models, planning costs and model fitting."""

from .costs import CoshLoss, cosh_loss, smooth_abs_loss
from .dynamics import EnsembleDynamics, MLPDynamics, Normalizers
from .train import TrainLog, evaluate_model, train_model

__all__ = ['CoshLoss', 'EnsembleDynamics', 'MLPDynamics', 'Normalizers',
           'TrainLog', 'cosh_loss', 'evaluate_model', 'smooth_abs_loss',
           'train_model']
