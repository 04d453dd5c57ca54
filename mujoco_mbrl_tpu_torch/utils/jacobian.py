"""Jacobian helper (port of mujoco_mbrl_tpu/utils/jacobian.py)."""

from __future__ import annotations

import torch


def compute_jacobian(fn, inputs: torch.Tensor) -> torch.Tensor:
    """d fn(x) / d x with shape (*fn(x).shape, *x.shape): forward mode
    when the output is at least as wide as the input, else reverse mode.
    iLQR's linearisation is this, per step of the nominal trajectory."""
    if fn(inputs).numel() >= inputs.numel():
        return torch.func.jacfwd(fn)(inputs)
    return torch.func.jacrev(fn)(inputs)
