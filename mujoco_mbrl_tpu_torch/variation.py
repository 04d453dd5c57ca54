"""Stochastic variation ops (composer/variation analogue), batched.

Port of mujoco_mbrl_tpu/variation.py. Every variation draws from an
explicit ``torch.Generator``:

* Distributions: ``dist(generator, shape=(), device=None) -> sample`` on
  ``device`` (default: the generator's).
* Noises wrap a distribution into a corruptor ``noise(generator, value)
  -> corrupted`` (additive / multiplicative, reference noises.py:30-70).
* ``evaluate`` resolves nested variation objects inside dicts, lists and
  tuples the way ``variation.evaluate`` does for attribute dicts.

The draws cannot match ``jax.random``'s; the tests hold them by their
law. JAX's ``evaluate`` folds each dict key in by Python's ``hash(k)``,
which changes with ``PYTHONHASHSEED`` for string keys; here each entry of
a dict takes its own sub-stream in the sorted order of its keys (each
element of a list in its order), seeded from the parent generator.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def _device(generator: torch.Generator, device):
    return torch.device(device) if device is not None else generator.device


class Variation:
    """Base: a callable (generator, shape, device) -> tensor."""

    def __call__(self, generator, shape=(), device=None):
        raise NotImplementedError


class Uniform(Variation):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape=(), device=None):
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        return (self.low + (self.high - self.low) * u).to(
            _device(generator, device))


class Normal(Variation):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape=(), device=None):
        z = torch.randn(tuple(shape), generator=generator,
                        device=generator.device)
        return (self.loc + self.scale * z).to(_device(generator, device))


class LogNormal(Variation):
    def __init__(self, mean=0.0, sigma=1.0):
        self.mean, self.sigma = mean, sigma

    def __call__(self, generator, shape=(), device=None):
        z = torch.randn(tuple(shape), generator=generator,
                        device=generator.device)
        return torch.exp(self.mean + self.sigma * z).to(
            _device(generator, device))


class Exponential(Variation):
    def __init__(self, scale=1.0):
        self.scale = scale

    def __call__(self, generator, shape=(), device=None):
        e = torch.empty(tuple(shape), device=generator.device).exponential_(
            generator=generator)
        return (self.scale * e).to(_device(generator, device))


class Bernoulli(Variation):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, generator, shape=(), device=None):
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        return (u < self.prob).to(_device(generator, device))


class UniformChoice(Variation):
    def __init__(self, choices: Sequence):
        self.choices = torch.as_tensor(choices)

    def __call__(self, generator, shape=(), device=None):
        idx = torch.randint(0, self.choices.shape[0], tuple(shape),
                            generator=generator, device=generator.device)
        dev = _device(generator, device)
        return self.choices.to(dev)[idx.to(dev)]


class UniformPointOnSphere(Variation):
    """Random unit vector (distributions.py UniformPointOnSphere)."""

    def __call__(self, generator, shape=(), device=None):
        v = torch.randn(tuple(shape) + (3,), generator=generator,
                        device=generator.device)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), min=1e-9)
        return v.to(_device(generator, device))


# ---- noises: corruptors (generator, value) -> corrupted value -----------

class Additive:
    """value + dist sample (noises.py Additive)."""

    def __init__(self, dist: Variation):
        self.dist = dist

    def __call__(self, generator, value):
        value = torch.as_tensor(value)
        return value + self.dist(generator, value.shape, value.device).to(
            value.dtype)


class Multiplicative:
    """value * dist sample (noises.py Multiplicative)."""

    def __init__(self, dist: Variation):
        self.dist = dist

    def __call__(self, generator, value):
        value = torch.as_tensor(value)
        return value * self.dist(generator, value.shape, value.device).to(
            value.dtype)


def _sub_generator(generator: torch.Generator) -> torch.Generator:
    """A generator on `generator`'s device seeded by one draw from it."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(device=generator.device).manual_seed(seed)


def evaluate(obj: Any, generator: torch.Generator):
    """Resolve every Variation inside a nested structure (variation/base.py
    evaluate): non-variations pass through; each dict entry (in sorted key
    order) and each list or tuple element draws from its own sub-stream
    of `generator`."""
    if isinstance(obj, dict):
        subs = {k: _sub_generator(generator)
                for k in sorted(obj, key=lambda k: (type(k).__name__,
                                                    str(k)))}
        return {k: evaluate(v, subs[k]) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        subs = [_sub_generator(generator) for _ in obj]
        return type(obj)(evaluate(v, g) for v, g in zip(obj, subs))
    if isinstance(obj, Variation):
        return obj(generator)
    return obj


__all__ = ['Additive', 'Bernoulli', 'Exponential', 'LogNormal',
           'Multiplicative', 'Normal', 'Uniform', 'UniformChoice',
           'UniformPointOnSphere', 'Variation', 'evaluate']
