"""Dynamics model and planning costs."""

from .costs import cosh_loss, smooth_abs_loss
from .dynamics import MLPDynamics, Normalizers

__all__ = ['MLPDynamics', 'Normalizers', 'cosh_loss', 'smooth_abs_loss']
