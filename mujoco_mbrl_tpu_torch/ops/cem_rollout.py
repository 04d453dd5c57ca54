"""Fused CEM sample + MLP rollout + cost: CUDA kernel and plain version.

``mlp_sample_rollout_costs`` replaces the TPU kernel
mujoco_mbrl_tpu/ops/cem_rollout.py:_sample_kernel_multi. For CUDA tensors
it launches ``csrc/cem_sample_rollout.cu`` (Philox noise in the kernel)
and raises on inputs the kernel does not take; for CPU tensors it runs
``mlp_sample_rollout_costs_plain``, which draws the same distributions
from a ``torch.Generator`` seeded by ``seed`` (or takes the noise ``z``
explicitly). Both return exact-K buffers: costs (B, K) float32 and
actions (B, H, ad, K). Dataset normalization folds into the first and
last layers (``_fold_normalizers``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, launch_counts

_SAMPLERS = {'triangular': 0, 'normal': 1}
MAX_SHARED_BYTES = 232448
_SIGNATURES = {
    'cem_smem_bytes': (ctypes.c_size_t, [ctypes.c_int] * 6),
    'cem_sample_rollout': (ctypes.c_int, [ctypes.c_void_p] * 11
                           + [ctypes.c_ulonglong] + [ctypes.c_int] * 8
                           + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3),
}


def _fold_normalizers(params, normalizers):
    """Fold affine (un)normalization into the MLP weights.

    norm(x) = (x - mu) / sigma  =>  W1' = W1 / sigma[:, None],
                                    b1' = b1 - (mu / sigma) @ W1
    unnorm(y) = y * sigma + mu  =>  W3' = W3 * sigma[None, :],
                                    b3' = b3 * sigma + mu
    """
    w1, b1 = params['l1']['w'], params['l1']['b']
    w2, b2 = params['l2']['w'], params['l2']['b']
    w3, b3 = params['l3']['w'], params['l3']['b']
    if normalizers is not None and normalizers.state_mean is not None:
        sd = normalizers.state_mean.shape[-1]
        s_mu, s_sig = normalizers.state_mean, normalizers.state_std + 1e-6
        if normalizers.action_mean is not None:
            a_mu = normalizers.action_mean
            a_sig = normalizers.action_std + 1e-6
        else:
            a_mu = torch.zeros(w1.shape[-2] - sd, dtype=w1.dtype,
                               device=w1.device)
            a_sig = torch.ones_like(a_mu)
        mu = torch.cat([s_mu, a_mu])
        sig = torch.cat([s_sig, a_sig])
        b1 = b1 - (mu / sig) @ w1
        w1 = w1 / sig[:, None]
        b3 = b3 * s_sig + s_mu
        w3 = w3 * s_sig[None, :]
    return w1, b1, w2, b2, w3, b3


def mlp_rollout_costs_reference(params, s0, actions, goal, weights,
                                normalizers=None, alpha_state: float = 0.4,
                                alpha_action: float = 0.25) -> torch.Tensor:
    """Plain rollout + accumulated cost for GIVEN actions.

    s0 (..., sd), actions (H, ..., ad) -> costs (...). Port of the JAX
    ``mlp_rollout_costs_reference``.
    """
    w1, b1, w2, b2, w3, b3 = _fold_normalizers(params, normalizers)
    s = s0
    acc = torch.zeros(s0.shape[:-1], dtype=s0.dtype, device=s0.device)
    for a in actions:
        h = torch.relu(torch.cat([s, a], dim=-1) @ w1 + b1)
        h = torch.relu(h @ w2 + b2)
        s = h @ w3 + b3
        d = (s - goal) * weights
        acc = acc + (torch.sum(torch.sqrt(d * d + alpha_state ** 2)
                               - alpha_state, dim=-1)
                     + alpha_action ** 2 * torch.mean(
                         torch.cosh(a / alpha_action) - 1.0, dim=-1))
    return acc


def rollout_costs_of_actions(params, s0, actions, goal, weights,
                             normalizers=None, alpha_state: float = 0.4,
                             alpha_action: float = 0.25) -> torch.Tensor:
    """Costs (B, K) of sampler-layout actions (B, H, ad, K) from s0 (B, sd)."""
    B, H, ad, K = actions.shape
    s = s0[:, None, :].expand(B, K, s0.shape[-1])
    return mlp_rollout_costs_reference(
        params, s, actions.permute(1, 0, 3, 2), goal, weights, normalizers,
        alpha_state, alpha_action)


def draw_noise(generator: torch.Generator, shape, sampler: str,
               dtype=torch.float32) -> torch.Tensor:
    """Unit-variance proposal noise: triangular (u1 + u2 - 1) * sqrt(6)
    or Box-Muller normal with u1 clipped to >= 1e-7."""
    u = torch.rand((2,) + tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    if sampler == 'triangular':
        return (u[0] + u[1] - 1.0) * 2.4494897
    if sampler == 'normal':
        return torch.sqrt(-2.0 * torch.log(torch.clamp(u[0], 1e-7, 1.0))) \
            * torch.cos((2.0 * math.pi) * u[1])
    raise NotImplementedError(
        f'sampler {sampler!r} is not ported (mujoco_mbrl_tpu.ops.cem_rollout'
        '._sample_kernel spline4)')


def actions_from_noise(mean, std, z, num_candidates: int,
                       antithetic: bool = True, action_low: float = -1.0,
                       action_high: float = 1.0) -> torch.Tensor:
    """(B, H, ad, K) clipped candidates; z (B, H, ad, Kz), Kz = ceil(K/2)
    when antithetic (candidate k + Kz gets -z[k]) else K."""
    K = num_candidates
    if antithetic:
        z = torch.cat([z, -z[..., :K - z.shape[-1]]], dim=-1)
    return torch.clamp(mean[..., None] + std[..., None] * z, action_low,
                       action_high)


def mlp_sample_rollout_costs_plain(
        params, seed, s0, mean, std, goal, weights, num_candidates: int,
        normalizers=None, alpha_state: float = 0.4,
        alpha_action: float = 0.25, action_low: float = -1.0,
        action_high: float = 1.0, antithetic: bool = True,
        sampler: str = 'triangular', z: Optional[torch.Tensor] = None):
    """Plain version: noise from ``torch.Generator().manual_seed(seed)``
    unless ``z`` (B, H, ad, Kz) is given. Returns (costs, actions)."""
    B, H, ad = mean.shape
    K = num_candidates
    if z is None:
        g = torch.Generator(device=s0.device).manual_seed(int(seed))
        z = draw_noise(g, (B, H, ad, (K + 1) // 2 if antithetic else K),
                       sampler, s0.dtype)
    actions = actions_from_noise(mean, std, z, K, antithetic, action_low,
                                 action_high)
    costs = rollout_costs_of_actions(params, s0, actions, goal, weights,
                                     normalizers, alpha_state, alpha_action)
    return costs, actions


def mlp_sample_rollout_costs(params, seed, s0, mean, std, goal, weights,
                             num_candidates: int, normalizers=None,
                             alpha_state: float = 0.4,
                             alpha_action: float = 0.25,
                             action_low: float = -1.0,
                             action_high: float = 1.0,
                             antithetic: bool = True,
                             sampler: str = 'triangular'):
    """Sample + roll out + cost K candidates per env.

    s0 (B, sd), mean / std (B, H, ad), goal / weights (sd,), ``seed`` an
    int. Returns costs (B, K) float32 and actions (B, H, ad, K). CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not s0.is_cuda:
        return mlp_sample_rollout_costs_plain(
            params, seed, s0, mean, std, goal, weights, num_candidates,
            normalizers, alpha_state, alpha_action, action_low, action_high,
            antithetic, sampler)
    if sampler not in _SAMPLERS:
        raise NotImplementedError(
            f'sampler {sampler!r} has no CUDA kernel (spline4 waits for '
            'mujoco_mbrl_tpu.ops.cem_rollout._sample_kernel)')
    w1, b1, w2, b2, w3, b3 = (t.contiguous() for t in
                              _fold_normalizers(params, normalizers))
    B, sd = s0.shape
    _, H, ad = mean.shape
    hid, K = w2.shape[0], int(num_candidates)
    tensors = (s0, mean, std, w1, b1, w2, b2, w3, b3, goal, weights)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('mlp_sample_rollout_costs kernel takes '
                             'contiguous float32 CUDA tensors')
    if (mean.shape != std.shape or mean.shape[0] != B
            or w1.shape != (sd + ad, hid) or w3.shape != (hid, sd)
            or goal.shape != (sd,) or weights.shape != (sd,)):
        raise ValueError('mlp_sample_rollout_costs: inconsistent shapes')
    lib = _build.library('cem_sample_rollout', _SIGNATURES)
    if lib.cem_smem_bytes(K, H, sd, ad, hid, int(antithetic)) > \
            MAX_SHARED_BYTES:
        raise ValueError('mlp_sample_rollout_costs: model too large for the '
                         'kernel shared-memory layout')
    costs = torch.empty((B, K), dtype=torch.float32, device=s0.device)
    actions = torch.empty((B, H, ad, K), dtype=torch.float32,
                          device=s0.device)
    rc = lib.cem_sample_rollout(
        *(t.data_ptr() for t in tensors), int(seed) & (2 ** 64 - 1),
        B, K, H, sd, ad, hid, _SAMPLERS[sampler], int(bool(antithetic)),
        float(action_low), float(action_high), float(alpha_state),
        float(alpha_action), costs.data_ptr(), actions.data_ptr(),
        torch.cuda.current_stream(s0.device).cuda_stream)
    _build.check(rc, 'mlp_sample_rollout_costs')
    launch_counts['cem_sample_rollout'] += 1
    return costs, actions
