"""Composer observation pipeline: buffering, delays, corruptors,
aggregators, as a carried-state transform over a batch of envs.

Port of mujoco_mbrl_tpu/observation.py (the functional redesign of
``dm_control/composer/observation/updater.py:90`` and
``obs_buffer.py:53``): each configured observable owns fixed-shape
buffers carried through the env's steps, with the env batch leading:

* ``pending``: (B, delay+1, *shape) conveyor; a sample written at step t
  matures ``delay`` control steps later (obs_buffer's delayed arrivals).
* ``ring``: (B, buffer_size, *shape) of matured samples, newest last
  (obs_buffer's bounded buffer).
* ``step``: (B,) control-step counter.

Sampling is at CONTROL-step granularity, as in the JAX package (its
documented deviation): ``update_interval`` counts control steps. An
aggregator reduces the ring over its dim 1 (the buffer axis; dim 0 is the
env batch). ``median`` of an even count is the mean of the two middle
values, as ``jnp.median`` gives (``torch.median`` returns the lower).
Corruptors draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _median(buf: torch.Tensor) -> torch.Tensor:
    s = torch.sort(buf, dim=1).values
    n = s.shape[1]
    if n % 2:
        return s[:, n // 2]
    return 0.5 * (s[:, n // 2 - 1] + s[:, n // 2])


def _sum(buf: torch.Tensor) -> torch.Tensor:
    # oldest to newest, one addition at a time: the order XLA's reduce of
    # a short ring takes (and jnp.mean multiplies by 1/n in the dtype), so
    # a JAX caller's value is matched bit for bit
    out = buf[:, 0]
    for i in range(1, buf.shape[1]):
        out = out + buf[:, i]
    return out


AGGREGATORS: Dict[str, Callable] = {
    'mean': lambda buf: _sum(buf) * buf.new_tensor(1.0 / buf.shape[1]),
    'median': _median,
    'max': lambda buf: torch.amax(buf, dim=1),
    'min': lambda buf: torch.amin(buf, dim=1),
    'sum': _sum,
}


class ObservableSpec:
    """Per-observable pipeline options (observable.Observable's
    enabled/update_interval/buffer_size/delay/aggregator/corruptor)."""

    def __init__(self, update_interval: int = 1, buffer_size: int = 1,
                 delay: int = 0, aggregator=None,
                 corruptor: Optional[Callable] = None,
                 enabled: bool = True):
        if isinstance(aggregator, str):
            aggregator = AGGREGATORS[aggregator]
        self.update_interval = int(update_interval)
        self.buffer_size = int(buffer_size)
        self.delay = int(delay)
        self.aggregator = aggregator
        self.corruptor = corruptor
        self.enabled = enabled


@dataclasses.dataclass(frozen=True)
class BufferState:
    pending: torch.Tensor   # (B, delay+1, *shape) conveyor toward maturity
    ring: torch.Tensor      # (B, buffer_size, *shape), newest last
    step: torch.Tensor      # (B,) int32 control-step counter


def init_buffer(spec: ObservableSpec, value: torch.Tensor) -> BufferState:
    """Fill the buffers with the initial sample (B, *shape): the updater
    primes them at episode start so the first observation is defined."""
    value = torch.as_tensor(value)
    B, shape = value.shape[0], tuple(value.shape[1:])
    fill = lambda n: value[:, None].expand((B, n) + shape).clone()
    return BufferState(pending=fill(spec.delay + 1),
                       ring=fill(spec.buffer_size),
                       step=torch.zeros((B,), dtype=torch.int32,
                                        device=value.device))


def _per_env(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def update_buffer(spec: ObservableSpec, st: BufferState,
                  value: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> BufferState:
    """Advance one control step: sample (every update_interval steps,
    corrupted if configured), age the delay conveyor, absorb matured
    samples into the bounded ring."""
    value = torch.as_tensor(value)
    if spec.corruptor is not None:
        if generator is None:
            raise ValueError('corruptor configured but no generator provided')
        value = spec.corruptor(generator, value)
    do_sample = (st.step % spec.update_interval) == 0
    # conveyor: slot i matures in i steps. Insert the new sample at slot
    # `delay` FIRST (so delay=0 matures this very step), then pop slot 0
    # and shift
    written = st.pending.clone()
    written[:, spec.delay] = value.to(written.dtype)
    inserted = torch.where(_per_env(do_sample, written), written, st.pending)
    matured = inserted[:, 0]
    pending = torch.cat([inserted[:, 1:], inserted[:, -1:]], dim=1)
    # a sample matures now iff one was taken `delay` steps ago
    took_then = (((st.step - spec.delay) % spec.update_interval == 0)
                 & (st.step >= spec.delay))
    shifted = torch.cat([st.ring[:, 1:], matured[:, None]], dim=1)
    ring = torch.where(_per_env(took_then, shifted), shifted, st.ring)
    return BufferState(pending=pending, ring=ring, step=st.step + 1)


def read_buffer(spec: ObservableSpec, st: BufferState) -> torch.Tensor:
    """Observation value: the aggregator over the ring, the raw ring
    (B, buffer_size, ...) when buffer_size > 1 and no aggregator (the
    updater returns the stacked buffer), or the newest sample."""
    if spec.aggregator is not None:
        return spec.aggregator(st.ring)
    if spec.buffer_size > 1:
        return st.ring
    return st.ring[:, -1]


def _split_key(key: int, n: int = 2):
    """`n` independent integer seeds from one (the host-side counterpart
    of ``jax.random.split`` for the pipeline's corruptor streams)."""
    words = np.random.SeedSequence(int(key)).generate_state(n, np.uint64)
    return [int(w >> np.uint64(1)) for w in words]


class BufferedEnvironment:
    """Wrap a control.Environment with the observation pipeline.

    Observables without a spec pass through untouched; spec'd ones are
    buffered, delayed and corrupted. The carried state is a dict: the
    inner EnvState, a BufferState per enabled observable and ``key``, an
    integer seed of the corruptors' streams (each step splits it, so a
    state stepped twice draws the same noise, as JAX's carried key does).
    """

    def __init__(self, env, specs: Dict[str, ObservableSpec]):
        self._env = env
        self._specs = dict(specs)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _process(self, buffers, key, obs):
        new_buffers = {}
        out = dict(obs)
        for name, spec in self._specs.items():
            if not spec.enabled:
                out.pop(name, None)
                continue
            key, sub = _split_key(key)
            g = None
            if spec.corruptor is not None:
                g = torch.Generator(device=obs[name].device).manual_seed(sub)
            st = update_buffer(spec, buffers[name], obs[name], g)
            new_buffers[name] = st
            out[name] = read_buffer(spec, st)
        return new_buffers, key, out

    def reset(self, batch: int, generator: torch.Generator):
        key = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                device=generator.device).item())
        inner_state, ts = self._env.reset(batch, generator)
        # the updater primes the buffers with the first sample
        buffers = {name: init_buffer(spec, ts.observation[name])
                   for name, spec in self._specs.items() if spec.enabled}
        obs = dict(ts.observation)
        for name, spec in self._specs.items():
            if spec.enabled:
                obs[name] = read_buffer(spec, buffers[name])
            else:
                obs.pop(name, None)
        state = dict(inner=inner_state, buffers=buffers, key=key)
        return state, dataclasses.replace(ts, observation=obs)

    def step(self, state, action):
        inner_state, ts = self._env.step(state['inner'], action)
        buffers, key, obs = self._process(state['buffers'], state['key'],
                                          ts.observation)
        new_state = dict(inner=inner_state, buffers=buffers, key=key)
        return new_state, dataclasses.replace(ts, observation=obs)

    def step_with_data(self, state, action):
        # the collection path's variant (control.Environment
        # .step_with_data): without it __getattr__ would hand the buffered
        # dict state to the inner env and skip the pipeline
        inner_state, ts, data = self._env.step_with_data(
            state['inner'], action)
        buffers, key, obs = self._process(state['buffers'], state['key'],
                                          ts.observation)
        new_state = dict(inner=inner_state, buffers=buffers, key=key)
        return new_state, dataclasses.replace(ts, observation=obs), data
