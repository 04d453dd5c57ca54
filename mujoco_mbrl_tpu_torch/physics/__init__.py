"""Physics engine port: model, MJCF compiler, dynamics, collision, solver."""

from . import collision, engine, math, mjcf, model, smooth, solver
from .model import Data, Model, State, make_state

__all__ = ['collision', 'engine', 'math', 'mjcf', 'model', 'smooth',
           'solver', 'Data', 'Model', 'State', 'make_state']
