"""Scale-out on torch.distributed: device meshes, sharded collection,
data-parallel training.

Port of mujoco_mbrl_tpu/parallel: one process a card (NCCL) or a CPU
worker (gloo), a named ``DeviceMesh`` over the ranks, env batches
sharded over a mesh axis with no communication, and the gradient
all-reduce of data-parallel model fitting over the named axis or axes.
"""

from .mesh import (distributed_init, dp_train_step, make_mesh, replicate,
                   shard_batch, sharded_collect)

__all__ = ['make_mesh', 'shard_batch', 'replicate', 'distributed_init',
           'sharded_collect', 'dp_train_step']
