"""CEM candidate rollout + cost: CUDA kernels and plain versions.

``mlp_rollout_costs_t`` (and its (N, sd) / (H, N, ad) form
``mlp_rollout_costs``) replaces the TPU kernel
mujoco_mbrl_tpu/ops/cem_rollout.py:_kernel: the MLP rollout and cost of
GIVEN actions, the ``rollout_costs_fn`` of ``cem_batched``'s non-fused
branch. For CUDA tensors it launches ``csrc/cem_rollout_costs.cu`` (the
samplers' tensor-core body, reading the actions instead of drawing them;
weights packed by ``given_inputs``); for CPU tensors it runs
``mlp_rollout_costs_reference``.

``mlp_sample_rollout_costs`` replaces two TPU kernels of
mujoco_mbrl_tpu/ops/cem_rollout.py: ``_sample_kernel_multi`` (G envs per
program) and ``_sample_kernel`` (one env per program, with the ``spline4``
sampler). ``mlp_sample_rollout_costs_ensemble`` replaces the ensemble
TS-infinity pair ``_sample_kernel_ens_grouped`` and ``_sample_kernel_ens``:
candidate k is rolled by member k % n for the whole horizon. For CUDA
tensors each launches its kernel (``csrc/cem_sample_rollout.cu``,
``csrc/cem_sample_rollout_ens.cu``: the model products on the tensor
cores with the 3xTF32 split, weights staged by ``cem_mma.pack_weights``;
Philox noise in the kernel) and raises on inputs the kernel does not take
(sd + ad or hidden above 128); for CPU tensors each runs its plain
version, which draws the same distributions from a ``torch.Generator``
seeded by ``seed`` (or takes the noise ``z`` explicitly). All return
exact-K buffers: costs (B, K) float32 and actions (B, H, ad, K). Dataset
normalization folds into the first and last layers (``_fold_normalizers``),
as in the JAX package.

``compute_dtype=torch.bfloat16`` is the TPU kernels' bf16 mode: the folded
weights, goal, cost weights and start states are rounded to bf16, each
product accumulates in float32, and the rest rounds where the TPU kernel
body rounds as the reference runs it (the plain versions below say where);
the samplers' actions come back as bf16. CUDA tensors launch the bf16
instantiation of each kernel (``cem_mma.pack_weights_bf16``; one
``mma.sync`` m16n8k16 of bf16 operands a product); CPU tensors run the
plain bf16 versions. Any other ``compute_dtype`` raises.

Samplers: ``normal`` (Box-Muller, the default, as in JAX), ``triangular``
(Irwin-Hall(2) scaled to unit variance) and ``spline4`` (triangular knots
every 4 steps, lerped along the horizon and renormalised to unit
variance; the kernel draws knot i of a pair from the Philox counter
(env, i, pair, draw)). The TPU layout knobs ``envs_per_program``,
``unroll`` and ``return_padded`` have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, cem_mma, launch_counts

_SAMPLERS = {'triangular': 0, 'normal': 1, 'spline4': 2}
MAX_SHARED_BYTES = 232448
_SIGNATURES = {
    'cem_sample_smem_bytes': (ctypes.c_size_t, [ctypes.c_int] * 7),
    'cem_sample_instantiation': (ctypes.c_int, [ctypes.c_int] * 7
                                 + [ctypes.c_void_p]),
    'cem_sample_rollout': (ctypes.c_int, [ctypes.c_void_p] * 4
                           + [ctypes.c_ulonglong] + [ctypes.c_int] * 9
                           + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3),
}
_COSTS_SIGNATURES = {
    'cem_rollout_costs': (ctypes.c_int, [ctypes.c_void_p] * 4
                          + [ctypes.c_longlong] + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2),
}
_ENS_SIGNATURES = {
    'cem_ens_smem_bytes': (ctypes.c_size_t, [ctypes.c_int] * 8),
    'cem_sample_rollout_ens': (ctypes.c_int, [ctypes.c_void_p] * 4
                               + [ctypes.c_ulonglong] + [ctypes.c_int] * 10
                               + [ctypes.c_float] * 4
                               + [ctypes.c_void_p] * 3),
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


def _rounding(compute_dtype):
    """What rounds the model's operands and activations: nothing for
    float32 (``None``), ``cem_mma.bf16`` for torch.bfloat16; any other
    compute dtype raises."""
    if compute_dtype in (None, torch.float32):
        return lambda x: x
    if compute_dtype == torch.bfloat16:
        return cem_mma.bf16
    raise NotImplementedError(
        f'compute_dtype={compute_dtype} is not ported: the kernels run '
        'float32 or bfloat16 (mujoco_mbrl_tpu.ops.cem_rollout.'
        'mlp_sample_rollout_costs compute_dtype)')


def _rollout_costs(step, s0, actions, goal, weights, alpha_state,
                   alpha_action, rnd):
    """sum over t of the goal-state cost of s_{t+1} = step(s_t, a_t) and
    the cosh cost of a_t. ``rnd`` rounds what the bf16 TPU
    kernel body rounds as the reference runs it: the action, s - goal and
    the divisor alpha_action (a Python scalar takes the bf16 array's type
    in JAX); XLA drops the bf16 rounding of the product (s - goal) w and
    of the quotient a / alpha_action before they are widened, so both are
    float32. The sum is in the start states' dtype."""
    aa = float(rnd(torch.tensor(alpha_action, dtype=torch.float64)))
    s = s0
    acc = torch.zeros(s0.shape[:-1], dtype=s0.dtype, device=s0.device)
    for a in actions:
        a = rnd(a)
        s = step(s, a)
        d = rnd(s - goal) * weights
        acc = acc + (torch.sum(torch.sqrt(d * d + alpha_state ** 2)
                               - alpha_state, dim=-1)
                     + alpha_action ** 2 * torch.mean(
                         torch.cosh(a / aa) - 1.0, dim=-1))
    return acc


def mlp_rollout_costs_reference(params, s0, actions, goal, weights,
                                normalizers=None, alpha_state: float = 0.4,
                                alpha_action: float = 0.25,
                                compute_dtype=None) -> torch.Tensor:
    """Plain rollout + accumulated cost for GIVEN actions.

    s0 (..., sd), actions (H, ..., ad) -> costs (...). Port of the JAX
    ``mlp_rollout_costs_reference``; with ``compute_dtype=torch.bfloat16``
    the plain version of the bf16 TPU kernel body: weights (folded as
    ``_fold_normalizers`` folds them), goal, cost weights, start states
    and actions rounded to bf16, each product in float32 with its float32
    bias, the hidden activations rounded after each ReLU and the state
    after layer 3, the costs in float32 (``_rollout_costs``).
    """
    rnd = _rounding(compute_dtype)
    w1, b1, w2, b2, w3, b3 = (rnd(t) for t in _fold_normalizers(
        params, normalizers))

    def step(s, a):
        h = rnd(torch.relu(torch.cat([s, a], dim=-1) @ w1 + b1))
        h = rnd(torch.relu(h @ w2 + b2))
        return rnd(h @ w3 + b3)
    return _rollout_costs(step, rnd(s0), actions, rnd(goal), rnd(weights),
                          alpha_state, alpha_action, rnd)


def given_inputs(params, normalizers, goal, weights, bf16: bool = False):
    """What the given-action kernel reads besides s0T and the actions: the
    packed weights (1, layout.total), folded in coordinates centred at the
    state mean mu (``cem_mma.centred_weights``: the same buffer the sampler
    kernels read), and mu (sd,), which the kernel subtracts from each start
    state as it loads it. bf16: the uncentred fold packed as bf16
    (``cem_mma.pack_weights_bf16``) and mu = 0."""
    if bf16:
        w = (t.detach() for t in _fold_normalizers(params, normalizers))
        return (cem_mma.pack_weights_bf16(*w, goal, weights),
                torch.zeros_like(goal))
    *w, mu, goal_c = (t.detach() for t in cem_mma.centred_weights(
        params, normalizers, goal))
    return cem_mma.pack_weights(*w, goal_c, weights), mu.contiguous()


def mlp_rollout_costs_t(params, s0T, actionsT, goal, weights,
                        normalizers=None, alpha_state: float = 0.4,
                        alpha_action: float = 0.25,
                        compute_dtype=None) -> torch.Tensor:
    """Rollout + cost of given actions in the kernel's layout: s0T (sd, N),
    actionsT (H, ad, N) -> costs (N,) float32. CPU tensors run
    ``mlp_rollout_costs_reference``; CUDA tensors launch the kernel on the
    current stream (the tensor-core body of the samplers: 3xTF32, or bf16
    with ``compute_dtype=torch.bfloat16``, which rounds the float32 s0T
    and actionsT as it loads them) and raise on inputs it does not take
    (sd + ad or hidden above 128). The TPU ``tile`` and ``interpret`` knobs
    have no counterpart."""
    bf16 = _is_bf16(compute_dtype)
    if not s0T.is_cuda:
        return mlp_rollout_costs_reference(
            params, s0T.T, actionsT.transpose(1, 2), goal, weights,
            normalizers, alpha_state, alpha_action, compute_dtype)
    sd, N = s0T.shape
    H, ad = actionsT.shape[:2]
    w1, w2, w3 = (params[l]['w'] for l in ('l1', 'l2', 'l3'))
    hid = w2.shape[0]
    leaves = [v for layer in params.values() for v in layer.values()]
    for t in (s0T, actionsT, goal, weights, *leaves):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError('mlp_rollout_costs_t kernel takes float32 CUDA '
                             'tensors')
    if not (s0T.is_contiguous() and actionsT.is_contiguous()):
        raise ValueError('mlp_rollout_costs_t kernel takes contiguous s0T '
                         'and actionsT')
    if (actionsT.shape != (H, ad, N) or w1.shape != (sd + ad, hid)
            or params['l1']['b'].shape != (hid,) or w2.shape != (hid, hid)
            or w3.shape != (hid, sd) or params['l3']['b'].shape != (sd,)
            or goal.shape != (sd,) or weights.shape != (sd,)):
        raise ValueError('mlp_rollout_costs_t: inconsistent shapes')
    cem_mma.check_shapes('mlp_rollout_costs_t', sd, ad, hid, bf16)
    packed, mu = given_inputs(params, normalizers, goal, weights, bf16)
    lib = _build.library('cem_rollout_costs', _COSTS_SIGNATURES)
    costs = torch.empty((N,), dtype=torch.float32, device=s0T.device)
    rc = lib.cem_rollout_costs(
        s0T.data_ptr(), mu.data_ptr(), actionsT.data_ptr(), packed.data_ptr(),
        N, H, sd, ad, hid, int(bf16), float(alpha_state),
        float(alpha_action), costs.data_ptr(),
        torch.cuda.current_stream(s0T.device).cuda_stream)
    _build.check(rc, 'mlp_rollout_costs_t')
    launch_counts[_counter('cem_rollout_costs', bf16)] += 1
    return costs


def _is_bf16(compute_dtype) -> bool:
    """Whether the kernels run bf16 (torch.bfloat16) or float32 (None or
    torch.float32); any other compute dtype raises."""
    _rounding(compute_dtype)
    return compute_dtype == torch.bfloat16


def _counter(name: str, bf16: bool) -> str:
    """The launch counter of kernel ``name`` in its float32 or bf16 mode."""
    return f'{name}_bf16' if bf16 else name


def mlp_rollout_costs(params, s0, actions, goal, weights, normalizers=None,
                      alpha_state: float = 0.4, alpha_action: float = 0.25,
                      compute_dtype=None) -> torch.Tensor:
    """Costs (K,) of candidates s0 (K, sd), actions (H, K, ad): the JAX
    ``mlp_rollout_costs`` layout, through ``mlp_rollout_costs_t``."""
    return mlp_rollout_costs_t(
        params, s0.T.contiguous(), actions.transpose(1, 2).contiguous(),
        goal, weights, normalizers, alpha_state, alpha_action, compute_dtype)


def rollout_costs_of_actions(params, s0, actions, goal, weights,
                             normalizers=None, alpha_state: float = 0.4,
                             alpha_action: float = 0.25,
                             compute_dtype=None) -> torch.Tensor:
    """Costs (B, K) of sampler-layout actions (B, H, ad, K) from s0 (B, sd)."""
    B, H, ad, K = actions.shape
    s = s0[:, None, :].expand(B, K, s0.shape[-1])
    return mlp_rollout_costs_reference(
        params, s, actions.permute(1, 0, 3, 2).to(s0.dtype), goal, weights,
        normalizers, alpha_state, alpha_action, compute_dtype)


def rollout_costs_of_actions_ensemble(params, s0, actions, goal, weights,
                                      normalizers=None,
                                      alpha_state: float = 0.4,
                                      alpha_action: float = 0.25,
                                      compute_dtype=None) -> torch.Tensor:
    """Costs (B, K) of sampler-layout actions (B, H, ad, K) from s0 (B, sd)
    under the ensemble ``params`` (leading member axis n, K % n == 0):
    candidate k is rolled by member k % n for the whole horizon, as
    ``EnsembleDynamics.forward_ts`` assigns it. The members run as one
    batched product per layer; bf16 rounds as
    ``mlp_rollout_costs_reference`` does."""
    rnd = _rounding(compute_dtype)
    w1, b1, w2, b2, w3, b3 = (rnd(t) for t in _fold_normalizers(
        params, normalizers))
    n = w1.shape[0]
    B, H, ad, K = actions.shape
    if K % n:
        raise ValueError(f'{K} candidates do not divide over {n} members')
    Kn, sd = K // n, s0.shape[-1]
    # (B, H, ad, Kn, n) -> (H, n, B * Kn, ad): member m takes k = q * n + m
    acts = actions.to(s0.dtype).reshape(B, H, ad, Kn, n).permute(
        1, 4, 0, 3, 2).reshape(H, n, B * Kn, ad)
    s = s0[None, :, None, :].expand(n, B, Kn, sd).reshape(n, B * Kn, sd)

    def step(s, a):
        h = rnd(torch.relu(torch.baddbmm(b1[:, None], torch.cat([s, a], -1),
                                         w1)))
        h = rnd(torch.relu(torch.baddbmm(b2[:, None], h, w2)))
        return rnd(torch.baddbmm(b3[:, None], h, w3))
    acc = _rollout_costs(step, rnd(s), acts, rnd(goal), rnd(weights),
                         alpha_state, alpha_action, rnd)
    return acc.reshape(n, B, Kn).permute(1, 2, 0).reshape(B, K)


def spline4_from_knots(knots: torch.Tensor, horizon: int) -> torch.Tensor:
    """spline4 noise (..., H, ad, Kz) from knots (..., n_knots, ad, Kz),
    n_knots = (H + 3) // 4 + 1: step t = 4 i + r takes knot i when r = 0,
    else ((1 - w) knot_i + w knot_{i+1}) / sqrt((1 - w)^2 + w^2) with
    w = r / 4 (mujoco_mbrl_tpu/ops/cem_rollout.py:295-306)."""
    rows = []
    for t in range(horizon):
        i, w = t // 4, (t % 4) * 0.25
        k0 = knots[..., i, :, :]
        rows.append(k0 if w == 0.0 else (
            ((1.0 - w) * k0 + w * knots[..., i + 1, :, :])
            * (1.0 / math.sqrt((1.0 - w) ** 2 + w ** 2))))
    return torch.stack(rows, dim=-3)


def draw_noise(generator: torch.Generator, shape, sampler: str,
               dtype=torch.float32) -> torch.Tensor:
    """Unit-variance proposal noise of ``shape`` (B, H, ad, Kz):
    triangular (u1 + u2 - 1) * sqrt(6), Box-Muller normal with u1 clipped
    to >= 1e-7, or spline4 from (H + 3) // 4 + 1 triangular knots."""
    if sampler == 'spline4':
        B, H, ad, Kz = shape
        knots = draw_noise(generator, (B, (H + 3) // 4 + 1, ad, Kz),
                           'triangular', dtype)
        return spline4_from_knots(knots, H)
    u = torch.rand((2,) + tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    if sampler == 'triangular':
        return (u[0] + u[1] - 1.0) * 2.4494897
    if sampler == 'normal':
        return torch.sqrt(-2.0 * torch.log(torch.clamp(u[0], 1e-7, 1.0))) \
            * torch.cos((2.0 * math.pi) * u[1])
    raise ValueError(f'unknown sampler {sampler!r}')


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


def _sample_actions(seed, s0, mean, std, num_candidates, antithetic,
                    sampler, action_low, action_high, z):
    B, H, ad = mean.shape
    K = num_candidates
    if z is None:
        g = torch.Generator(device=s0.device).manual_seed(int(seed))
        z = draw_noise(g, (B, H, ad, (K + 1) // 2 if antithetic else K),
                       sampler, s0.dtype)
    return actions_from_noise(mean, std, z, K, antithetic, action_low,
                              action_high)


def _out_actions(actions, compute_dtype):
    """The samplers' actions as they return them: bf16 in the bf16 mode
    (rounded after the clip, as the TPU kernels store them)."""
    return (actions.to(torch.bfloat16) if _is_bf16(compute_dtype)
            else actions)


def mlp_sample_rollout_costs_plain(
        params, seed, s0, mean, std, goal, weights, num_candidates: int,
        normalizers=None, alpha_state: float = 0.4,
        alpha_action: float = 0.25, action_low: float = -1.0,
        action_high: float = 1.0, antithetic: bool = True,
        sampler: str = 'normal', z: Optional[torch.Tensor] = None,
        compute_dtype=None):
    """Plain version: noise from ``torch.Generator().manual_seed(seed)``
    unless ``z`` (B, H, ad, Kz) is given. Returns (costs, actions); with
    bf16 the actions are rounded after the clip, returned as bf16 and
    costed as ``mlp_rollout_costs_reference`` costs them in bf16."""
    actions = _out_actions(_sample_actions(
        seed, s0, mean, std, num_candidates, antithetic, sampler, action_low,
        action_high, z), compute_dtype)
    costs = rollout_costs_of_actions(params, s0, actions, goal, weights,
                                     normalizers, alpha_state, alpha_action,
                                     compute_dtype)
    return costs, actions


def _kernel_inputs(what, params, normalizers, s0, mean, std, goal, weights,
                   n_members=None, bf16=False):
    """Every launch input, checked (float32 CUDA tensors of consistent
    shapes, the per-env inputs contiguous, sd + ad and hidden within the
    kernels' tiles), with the weights folded in the kernels' centred
    coordinates and packed for the tensor cores (``cem_mma``); bf16: the
    uncentred fold packed as bf16, the start states as given (the kernel
    rounds them as it loads them)."""
    B, sd = s0.shape
    _, H, ad = mean.shape
    w1, b1 = params['l1']['w'], params['l1']['b']
    w2, w3, b3 = params['l2']['w'], params['l3']['w'], params['l3']['b']
    hid = w2.shape[-1]
    lead = () if n_members is None else (n_members,)
    leaves = [v for layer in params.values() for v in layer.values()]
    for t in (s0, mean, std, goal, weights, *leaves):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f'{what} kernel takes float32 CUDA tensors')
    if not all(t.is_contiguous() for t in (s0, mean, std)):
        raise ValueError(f'{what} kernel takes contiguous s0, mean, std')
    if (mean.shape != std.shape or mean.shape[0] != B
            or w1.shape != lead + (sd + ad, hid)
            or w2.shape != lead + (hid, hid) or w3.shape != lead + (hid, sd)
            or b1.shape != lead + (hid,) or b3.shape != lead + (sd,)
            or goal.shape != (sd,) or weights.shape != (sd,)):
        raise ValueError(f'{what}: inconsistent shapes')
    cem_mma.check_shapes(what, sd, ad, hid, bf16)
    if bf16:
        folded = (t.detach() for t in _fold_normalizers(params, normalizers))
        packed = cem_mma.pack_weights_bf16(*folded, goal, weights)
        return (s0, mean, std, packed), (B, H, sd, ad, hid)
    *folded, x0, goal_c = (t.detach() for t in cem_mma.fold_centred(
        params, normalizers, s0, goal))
    packed = cem_mma.pack_weights(*folded, goal_c, weights)
    return (x0.contiguous(), mean, std, packed), (B, H, sd, ad, hid)


def _check_smem(what, n_bytes):
    if n_bytes == 0 or n_bytes > MAX_SHARED_BYTES:
        raise ValueError(f'{what}: horizon x action dim too large for the '
                         f'kernel shared-memory scratch ({n_bytes} bytes)')


def mlp_sample_rollout_costs(params, seed, s0, mean, std, goal, weights,
                             num_candidates: int, normalizers=None,
                             alpha_state: float = 0.4,
                             alpha_action: float = 0.25,
                             action_low: float = -1.0,
                             action_high: float = 1.0,
                             antithetic: bool = True,
                             sampler: str = 'normal',
                             compute_dtype=None):
    """Sample + roll out + cost K candidates per env.

    s0 (B, sd), mean / std (B, H, ad), goal / weights (sd,), ``seed`` an
    int. Returns costs (B, K) float32 and actions (B, H, ad, K), float32 or,
    with ``compute_dtype=torch.bfloat16``, bf16. CPU tensors take the plain
    version; CUDA tensors launch the kernel (its bf16 instantiation in the
    bf16 mode).
    """
    bf16 = _is_bf16(compute_dtype)
    if sampler not in _SAMPLERS:
        raise ValueError(f'unknown sampler {sampler!r}')
    if not s0.is_cuda:
        return mlp_sample_rollout_costs_plain(
            params, seed, s0, mean, std, goal, weights, num_candidates,
            normalizers, alpha_state, alpha_action, action_low, action_high,
            antithetic, sampler, compute_dtype=compute_dtype)
    tensors, (B, H, sd, ad, hid) = _kernel_inputs(
        'mlp_sample_rollout_costs', params, normalizers, s0, mean, std, goal,
        weights, bf16=bf16)
    K = int(num_candidates)
    lib = _build.library('cem_sample_rollout', _SIGNATURES)
    _check_smem('mlp_sample_rollout_costs', lib.cem_sample_smem_bytes(
        K, H, sd, ad, hid, int(bool(antithetic)), int(bf16)))
    costs = torch.empty((B, K), dtype=torch.float32, device=s0.device)
    actions = torch.empty((B, H, ad, K), device=s0.device,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
    rc = lib.cem_sample_rollout(
        *(t.data_ptr() for t in tensors), int(seed) & (2 ** 64 - 1),
        B, K, H, sd, ad, hid, _SAMPLERS[sampler], int(bool(antithetic)),
        int(bf16), float(action_low), float(action_high), float(alpha_state),
        float(alpha_action), costs.data_ptr(), actions.data_ptr(),
        torch.cuda.current_stream(s0.device).cuda_stream)
    _build.check(rc, 'mlp_sample_rollout_costs')
    launch_counts[_counter('cem_sample_rollout', bf16)] += 1
    return costs, actions


def sampler_instantiation(K: int, H: int, sd: int, ad: int, hid: int,
                          antithetic: bool = True, compute_dtype=None):
    """The kernel instantiation that ``mlp_sample_rollout_costs`` launches
    at these sizes, as (NI, NH, NSO, exact, weights in shared memory): the
    tile bounds of [s; a], hidden and state, whether the loops run to the
    exact tile counts, whether the weights are staged in shared memory
    ((16, 16, 16, False, False) is the guarded instantiation; in bf16 NI
    and NH count k16 tiles, (8, 8, 16, False, False) guarded). Builds the
    kernel library; launches nothing."""
    lib = _build.library('cem_sample_rollout', _SIGNATURES)
    out = (ctypes.c_int * 5)()
    rc = lib.cem_sample_instantiation(int(K), int(H), int(sd), int(ad),
                                      int(hid), int(bool(antithetic)),
                                      int(_is_bf16(compute_dtype)),
                                      ctypes.addressof(out))
    _build.check(rc, 'sampler_instantiation')
    return tuple(out[:3]) + (bool(out[3]), bool(out[4]))


def _ensemble_sampler(sampler: str) -> str:
    # The JAX ensemble kernels know normal and triangular only: the
    # grouped kernel is skipped for spline4 (cem_rollout.py:981) and the
    # per-env kernel treats every sampler but 'triangular' as normal
    # (:873-878), so spline4 draws normal noise there. Both versions here
    # do the same.
    if sampler not in _SAMPLERS:
        raise ValueError(f'unknown sampler {sampler!r}')
    return 'normal' if sampler == 'spline4' else sampler


def mlp_sample_rollout_costs_ensemble_plain(
        params, seed, s0, mean, std, goal, weights, num_candidates: int,
        n_members: int, normalizers=None, alpha_state: float = 0.4,
        alpha_action: float = 0.25, action_low: float = -1.0,
        action_high: float = 1.0, antithetic: bool = True,
        sampler: str = 'normal', z: Optional[torch.Tensor] = None,
        compute_dtype=None):
    """Plain version of ``mlp_sample_rollout_costs_ensemble``: the
    single-MLP sampler's noise (``z`` or drawn from ``seed``), costs by
    member k % n. Returns (costs, actions), the actions bf16 in the bf16
    mode."""
    if num_candidates % n_members:
        raise ValueError(f'num_candidates {num_candidates} must divide '
                         f'evenly over {n_members} ensemble members')
    actions = _out_actions(_sample_actions(
        seed, s0, mean, std, num_candidates, antithetic,
        _ensemble_sampler(sampler), action_low, action_high, z),
        compute_dtype)
    costs = rollout_costs_of_actions_ensemble(
        params, s0, actions, goal, weights, normalizers, alpha_state,
        alpha_action, compute_dtype)
    return costs, actions


def mlp_sample_rollout_costs_ensemble(params, seed, s0, mean, std, goal,
                                      weights, num_candidates: int,
                                      n_members: int, normalizers=None,
                                      alpha_state: float = 0.4,
                                      alpha_action: float = 0.25,
                                      action_low: float = -1.0,
                                      action_high: float = 1.0,
                                      antithetic: bool = True,
                                      sampler: str = 'normal',
                                      compute_dtype=None):
    """Ensemble TS-infinity sample + roll out + cost, one launch.

    ``params`` leaves carry a leading (n_members,) axis (EnsembleDynamics
    layout); candidate k belongs to member k % n. Returns costs (B, K)
    float32 and actions (B, H, ad, K), bf16 with
    ``compute_dtype=torch.bfloat16``. CPU tensors take the plain version;
    CUDA tensors launch the kernel (its bf16 instantiation in the bf16
    mode).
    """
    bf16 = _is_bf16(compute_dtype)
    n, K = int(n_members), int(num_candidates)
    if K % n:
        raise ValueError(f'num_candidates {K} must divide evenly over {n} '
                         'ensemble members')
    sampler = _ensemble_sampler(sampler)
    if not s0.is_cuda:
        return mlp_sample_rollout_costs_ensemble_plain(
            params, seed, s0, mean, std, goal, weights, K, n, normalizers,
            alpha_state, alpha_action, action_low, action_high, antithetic,
            sampler, compute_dtype=compute_dtype)
    tensors, (B, H, sd, ad, hid) = _kernel_inputs(
        'mlp_sample_rollout_costs_ensemble', params, normalizers, s0, mean,
        std, goal, weights, n_members=n, bf16=bf16)
    lib = _build.library('cem_sample_rollout_ens', _ENS_SIGNATURES)
    _check_smem('mlp_sample_rollout_costs_ensemble', lib.cem_ens_smem_bytes(
        K, n, H, sd, ad, hid, int(bool(antithetic)), int(bf16)))
    costs = torch.empty((B, K), dtype=torch.float32, device=s0.device)
    actions = torch.empty((B, H, ad, K), device=s0.device,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
    rc = lib.cem_sample_rollout_ens(
        *(t.data_ptr() for t in tensors), int(seed) & (2 ** 64 - 1),
        B, K, n, H, sd, ad, hid, _SAMPLERS[sampler], int(bool(antithetic)),
        int(bf16), float(action_low), float(action_high), float(alpha_state),
        float(alpha_action), costs.data_ptr(), actions.data_ptr(),
        torch.cuda.current_stream(s0.device).cuda_stream)
    _build.check(rc, 'mlp_sample_rollout_costs_ensemble')
    launch_counts[_counter('cem_sample_rollout_ens', bf16)] += 1
    return costs, actions
