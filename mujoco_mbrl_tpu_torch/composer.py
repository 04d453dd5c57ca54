"""Composer-lite: entity/task composition over the programmatic builder.

Port of mujoco_mbrl_tpu/composer.py (a functional analogue of
dm_control's composer core, reference ``dm_control/composer/``):
reusable :class:`Entity` objects own an MJCF sub-model (built with
:mod:`physics.builder`) plus named :func:`observable` methods; a
:class:`Task` wires entities together and implements the lifecycle
hooks; :func:`make_env` compiles the composed scene into the port's
batched environment on ``device`` (default ``cuda``).

As in the JAX package, ``initialize_episode_mjcf`` runs once, at build;
per-episode variation goes through ``initialize_episode`` returning
episode params that ``apply_params`` turns into per-env model fields;
the substep hooks are out of scope. Observables, rewards and
terminations take ``(model, phys, data)`` of a batch of envs and return
the env batch as the leading dimension; ``initialize_episode(model,
batch, generator)`` draws from an explicit ``torch.Generator``.

``observable(observes_acc=True)`` marks an observable that reads
acceleration-stage Data (the walkers' accelerometer): the environment's
observation forward then runs the constraint solve, which it skips
otherwise when the task sets ``OBSERVES_ACC = False`` (in the JAX
package XLA drops the unused solve; eager PyTorch would run it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .physics import builder
from .physics import model as M
from .suite import base as suite_base
from .suite import control


def observable(fn: Callable = None, observes_acc: bool = False,
               **options) -> Callable:
    """Mark an Entity/Task method as a named observable (composer/
    define.py:59's `observable` decorator role). The method receives
    (model, phys, data) and returns a (B, ...) tensor.

    Optional pipeline options (update_interval, buffer_size, delay,
    aggregator, corruptor, enabled) configure the observation pipeline
    (observation.ObservableSpec), e.g.::

        @observable(buffer_size=4, aggregator='mean',
                    corruptor=variation.Additive(variation.Normal(0, .01)))
        def tip_position(self, model, phys, data): ...
    """
    def mark(f):
        f._is_observable = True
        f._observes_acc = bool(observes_acc)
        if options:
            from .observation import ObservableSpec
            f._observable_spec = ObservableSpec(**options)
        return f
    if fn is not None:
        return mark(fn)
    return mark


def _collect_observables(obj) -> Dict[str, Callable]:
    out = {}
    for name in dir(type(obj)):
        fn = getattr(type(obj), name, None)
        if callable(fn) and getattr(fn, '_is_observable', False):
            out[name] = getattr(obj, name)
    return out


def _collect_observable_specs(obj) -> Dict[str, Any]:
    from .observation import ObservableSpec
    out = {}
    for name in dir(type(obj)):
        fn = getattr(type(obj), name, None)
        spec = getattr(fn, '_observable_spec', None)
        if spec is not None:
            out[name] = spec
    # per-INSTANCE enabled overrides (Entity.enable_observable): specs
    # live on class methods, so flipping spec.enabled directly would
    # leak across every instance of the class
    for name, enabled in getattr(obj, '_observable_overrides', {}).items():
        base = out.get(name)
        if base is None:
            out[name] = ObservableSpec(enabled=enabled)
        else:
            out[name] = ObservableSpec(
                update_interval=base.update_interval,
                buffer_size=base.buffer_size, delay=base.delay,
                aggregator=base.aggregator, corruptor=base.corruptor,
                enabled=enabled)
    return out


class Entity:
    """A reusable scene component owning an MJCF sub-model
    (composer/entity.py:199).

    Subclasses implement ``_build() -> builder.RootElement`` and may
    decorate methods with :func:`observable`. ``prefix`` scopes the
    entity's names once attached.
    """

    def __init__(self, **kwargs):
        self._mjcf_root = self._build(**kwargs)
        self.prefix = ''
        self._observable_overrides: Dict[str, bool] = {}

    def enable_observable(self, name: str, enabled: bool = True) -> None:
        """Per-instance enable/disable of a named observable (the
        reference's `entity.observables.<name>.enabled = True` workflow).
        Call before make_env, e.g.
        ``walker.enable_observable('egocentric_camera')``."""
        if name not in _collect_observables(self):
            raise KeyError(f'{type(self).__name__} has no observable '
                           f'{name!r}')
        self._observable_overrides[name] = bool(enabled)

    def _build(self, **kwargs) -> builder.RootElement:
        raise NotImplementedError

    @property
    def mjcf_model(self) -> builder.RootElement:
        return self._mjcf_root

    def name(self, base: str) -> str:
        """Scoped name of one of this entity's elements after attach."""
        return self.prefix + base

    def observables(self) -> Dict[str, Callable]:
        return _collect_observables(self)

    # lifecycle hooks (no-ops by default; called by the Task)
    def initialize_episode(self, model, batch: int,
                           generator: torch.Generator):
        """Episode params of this entity for `batch` envs (or ())."""
        return ()

    def apply_params(self, model, params):
        return model


class Task:
    """Composed task: a root entity plus attached sub-entities
    (composer/task.py:44).

    Lifecycle: ``initialize_episode_mjcf`` (once, at build) -> compile ->
    per episode ``initialize_episode`` -> per step ``before_step`` /
    reward / observables. ``OBSERVES_ACC`` as in ``suite.base.Task``.
    """

    control_timestep: Optional[float] = None
    OBSERVES_ACC = True

    def __init__(self, root_entity: Entity):
        self.root_entity = root_entity
        self._entities = [root_entity]

    def attach(self, entity: Entity, prefix: str,
               frame: Optional[builder.Element] = None) -> Entity:
        """Attach `entity` under the root (or `frame`) with scoped names."""
        target = frame if frame is not None else \
            self.root_entity.mjcf_model.worldbody
        target.attach(entity.mjcf_model, prefix)
        entity.prefix = prefix
        self._entities.append(entity)
        return entity

    # -- lifecycle hooks -------------------------------------------------
    def initialize_episode_mjcf(self, root: builder.RootElement) -> None:
        """Mutate the composed model before compilation (runs once)."""

    def initialize_episode(self, model, batch: int,
                           generator: torch.Generator) -> Tuple[Any, Any]:
        """(physics State, params) of `batch` envs. Default: the reference
        pose plus each entity's episode params, drawn in entity order."""
        params = tuple(e.initialize_episode(model, batch, generator)
                       for e in self._entities)
        return M.make_state(model, batch=batch), params

    def apply_params(self, model, params):
        for e, p in zip(self._entities, params):
            model = e.apply_params(model, p)
        return model

    def before_step(self, action, model):
        return action

    def observables(self) -> Dict[str, Callable]:
        out = {}
        for e in self._entities:
            for name, fn in e.observables().items():
                out[(e.prefix + name) if e.prefix else name] = fn
        out.update(_collect_observables(self))
        return out

    def observable_specs(self) -> Dict[str, Any]:
        """Pipeline options per observable name (entities' prefixed)."""
        out = {}
        for e in self._entities:
            for name, spec in _collect_observable_specs(e).items():
                out[(e.prefix + name) if e.prefix else name] = spec
        out.update(_collect_observable_specs(self))
        return out

    def get_reward(self, model, phys, data, ctrl):
        raise NotImplementedError


class _TaskAdapter(suite_base.Task):
    """Bridges a composer Task onto the suite's batched Task protocol."""

    def __init__(self, task: Task):
        self._task = task
        self._observables = task.observables()
        # disabled observables are dropped at the source: they must not
        # be computed at all (an off-by-default egocentric camera would
        # otherwise render every step only to be discarded)
        for name, spec in task.observable_specs().items():
            if not spec.enabled:
                self._observables.pop(name, None)
        self.OBSERVES_ACC = bool(getattr(task, 'OBSERVES_ACC', True)) or any(
            getattr(fn, '_observes_acc', False)
            for fn in self._observables.values())
        # early termination is optional (rl/control.py:115-121): surfaced
        # only where the composer task defines it
        if hasattr(task, 'get_termination'):
            self.get_termination = task.get_termination

    def initialize_episode(self, model, batch, generator):
        return self._task.initialize_episode(model, batch, generator)

    def apply_params(self, model, params):
        return self._task.apply_params(model, params)

    def before_step(self, action, model):
        return self._task.before_step(action, model)

    def get_observation(self, model, phys, data):
        return {name: fn(model, phys, data)
                for name, fn in sorted(self._observables.items())}

    def get_reward(self, model, phys, data, ctrl):
        return self._task.get_reward(model, phys, data, ctrl)


def make_env(task: Task, time_limit: float = float('inf'), device=None,
             **environment_kwargs):
    """Compile the composed scene on `device` (default ``cuda``) and return
    the batched environment (composer/environment.py:266's Environment
    role), wrapped in the observation pipeline where an enabled
    observable asks for it."""
    root = task.root_entity.mjcf_model
    task.initialize_episode_mjcf(root)
    model = root.compile(device=device)
    if task.control_timestep is not None:
        environment_kwargs.setdefault('control_timestep',
                                      task.control_timestep)
    env = control.Environment(model, _TaskAdapter(task),
                              time_limit=time_limit, **environment_kwargs)
    # wrapped only where some ENABLED observable needs the pipeline; a
    # spec that merely disables must not change the env state's type
    specs = {name: s for name, s in task.observable_specs().items()
             if s.enabled and (s.update_interval > 1 or s.buffer_size > 1
                               or s.delay > 0 or s.aggregator is not None
                               or s.corruptor is not None)}
    if specs:
        from .observation import BufferedEnvironment
        env = BufferedEnvironment(env, specs)
    return env
