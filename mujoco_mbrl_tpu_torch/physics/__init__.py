"""Physics engine port: model, MJCF compiler, dynamics, collision, solver.

    model = parse(xml_string, dtype).to(device)
    state = make_state(model, batch=B)       # batched {qpos, qvel, time}
    state = step(model, state, ctrl)         # ctrl (B, nu)
"""

from . import collision, engine, math, mjcf, model, smooth, solver
from .engine import forward, n_substeps, step, substep
from .mjcf import parse
from .model import Data, Model, Option, State, make_state

__all__ = ['collision', 'engine', 'math', 'mjcf', 'model', 'smooth',
           'solver', 'forward', 'step', 'substep', 'n_substeps', 'parse',
           'Data', 'Model', 'Option', 'State', 'make_state']
