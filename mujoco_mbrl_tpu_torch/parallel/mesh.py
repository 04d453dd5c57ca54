"""Mesh construction and SPMD helpers on torch.distributed.

Port of mujoco_mbrl_tpu/parallel/mesh.py. The canonical layout: one mesh
axis ``'env'`` for everything embarrassingly parallel (env instances,
train microbatches), model parameters replicated; a second axis splits
the ranks into hosts x local ranks. Each process holds one card (backend
NCCL) or is a CPU worker (backend gloo); the backend follows the device
and nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..data import Rollouts
from ..device import resolve_device
from ..models.train import param_leaves

Axes = Union[str, Sequence[str]]


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> None:
    """Join the process group at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``) as rank ``process_id`` of ``num_processes``; a
    no-op when no coordinator is given (one process).

    On ``cuda`` (the default) the backend is NCCL and rank r takes card
    r % device_count; on ``cpu`` it is gloo. One all-reduce on the device
    proves the group formed, so a group that cannot form raises here.
    """
    if coordinator_address is None:
        return
    dev = resolve_device(device)
    init = (coordinator_address if '://' in coordinator_address
            else f'tcp://{coordinator_address}')
    rank = int(process_id or 0)
    if dev.type == 'cuda':
        dev = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                            init_method=init, world_size=int(num_processes),
                            rank=rank)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f'the process group did not form: all-reduce '
                           f'of ones gave {probe.item()}')


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs the process group: call '
                           'distributed_init (or init_process_group) first')
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(axis_names: Sequence[str] = ('env',),
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """1-D mesh over the ranks (``devices``, default all), or 2-D hosts x
    local ranks (``LOCAL_WORLD_SIZE`` ranks a host; 1 x n when that does
    not divide)."""
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size() if dist.is_initialized()
                            else 1))
    device_type = _device_type()
    n = len(ranks)
    if len(axis_names) == 1:
        shape: Tuple[int, ...] = (n,)
    elif len(axis_names) == 2:
        local = int(os.environ.get('LOCAL_WORLD_SIZE', n))
        hosts = n // local if local and n % local == 0 else 1
        shape = (hosts, n // hosts)
    else:
        raise ValueError('1 or 2 mesh axes supported')
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_batch(mesh: DeviceMesh, axis: Axes = 'env') -> list:
    """Placements of a tensor whose leading batch dim is split over
    ``axis`` (and replicated over the mesh's other dims)."""
    axes = _axes(axis)
    return [Shard(0) if name in axes else Replicate()
            for name in mesh.mesh_dim_names]


def replicate(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def _share(mesh: DeviceMesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's index among the shards over ``axes``, the number of
    shards)."""
    coord = mesh.get_coordinate()
    k, n = 0, 1
    for name in axes:
        dim = mesh.mesh_dim_names.index(name)
        k = k * mesh.size(dim) + coord[dim]
        n *= mesh.size(dim)
    return k, n


def _take_rows(tree, rows: slice, n: int):
    """Every tensor of a (nested) tree whose leading dim is the global
    batch ``n``, cut to ``rows``; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree[rows] if tree.dim() and tree.shape[0] == n else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take_rows(t, rows, n) for t in tree)
    if isinstance(tree, dict):
        return {k: _take_rows(v, rows, n) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _take_rows(getattr(tree, f.name), rows, n)
            for f in dataclasses.fields(tree)})
    return tree


def sharded_collect(mesh: DeviceMesh, wrapper, num_rollouts: int,
                    num_steps: int, policy: Optional[Callable] = None,
                    policy_init: Optional[Callable] = None,
                    axis: Axes = 'env'):
    """A rollout collector whose env batch is sharded over ``axis``.

    Returns ``collect(generator, goal_state=None) -> Rollouts`` whose
    arrays are DTensors sharded on dim 0 over the axis: each rank steps
    only its share of the ``num_rollouts`` lockstep envs, with no
    communication. The episode draws (``initialize_episode``) and the
    random actions are drawn for the whole batch from ``generator`` (the
    same seed on every rank) and cut to the rank's rows, so one seed
    gives the same global rollouts as ``wrapper.get_rollouts`` whatever
    the world size. A given ``policy`` (the batched protocol of
    ``collect_from``) sees the rank's rows only.
    """
    axes = _axes(axis)
    k, n = _share(mesh, axes)
    if num_rollouts % n != 0:
        raise ValueError(
            f'num_rollouts {num_rollouts} must divide over mesh axis '
            f'{axis} of size {n}')
    share = num_rollouts // n
    rows = slice(k * share, (k + 1) * share)
    placements = shard_batch(mesh, axes)

    def random_policy(generator, t, state, obs, carry):
        return wrapper.sample_action(generator, (num_rollouts,))[rows], carry

    def collect(generator: torch.Generator, goal_state=None) -> Rollouts:
        env = wrapper.env
        phys, params = env.task.initialize_episode(env.model, num_rollouts,
                                                   generator)
        env_state, _ = env.start(_take_rows(phys, rows, num_rollouts),
                                 _take_rows(params, rows, num_rollouts))
        if goal_state is not None:
            env_state = wrapper.apply_goal(
                env_state, _take_rows(goal_state, rows, num_rollouts))
        local = wrapper.collect_from(env_state, num_steps,
                                     policy or random_policy, generator,
                                     policy_init, sorted_later_obs=False)
        return Rollouts(**{
            f.name: DTensor.from_local(getattr(local, f.name), mesh,
                                       placements)
            for f in dataclasses.fields(local)})

    return collect


def dp_train_step(mesh: DeviceMesh, model, optimizer: Callable,
                  normalizers=None, axis: Axes = 'env'):
    """Data-parallel model update: a microbatch a rank, gradients and loss
    averaged by ``all_reduce`` over ``axis`` (one name or a tuple: on a
    hosts x local mesh, ``('host', 'env')`` reduces over the whole grid),
    parameters replicated (every rank applies the same update).

    ``optimizer`` is a factory over the parameter leaves
    (``models.train.sgd(0.1)``). Returns ``step(params, opt_state, batch)
    -> (params, opt_state, loss)``: ``opt_state`` is the torch optimizer
    the first call (``None``) builds; a ``batch`` field is the global
    batch (its leading dim divisible by the axis size; the rank takes its
    share) or a DTensor sharded on dim 0 (the rank takes its local
    shard). The params are updated in place, as ``models.train`` does.
    """
    axes = _axes(axis)
    k, n = _share(mesh, axes)
    groups = [mesh.get_group(name) for name in axes]

    def local_rows(x):
        if isinstance(x, DTensor):
            return x.to_local()
        if x.shape[0] % n:
            raise ValueError(f'batch of {x.shape[0]} does not divide over '
                             f'mesh axis {axis} of size {n}')
        share = x.shape[0] // n
        return x[k * share:(k + 1) * share]

    def mean_over_axes(t):
        for g in groups:
            dist.all_reduce(t, group=g)
        return t.div_(n)

    def step(params, opt_state, batch):
        leaves = param_leaves(params)
        if opt_state is None:
            for leaf in leaves:
                leaf.requires_grad_(True)
            opt_state = optimizer(leaves)
        local = {key: local_rows(v) for key, v in batch.items()}
        opt_state.zero_grad(set_to_none=True)
        out = model.loss(params, local, normalizers)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        for leaf in leaves:
            mean_over_axes(leaf.grad)
        opt_state.step()
        return params, opt_state, mean_over_axes(loss.detach().clone())

    return step
