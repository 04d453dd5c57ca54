"""Scale-out on torch.distributed, port against the JAX package
(``parallel``) and against itself on one process, plus ``utils.profiling``.

Two gloo processes on the CPU (each a subprocess with its own timeout,
running only the port) take the same global batch and seed:
``dp_train_step`` of an ``MLPDynamics`` equals the single-process
full-batch step and JAX's ``dp_train_step`` on a virtual 2-device mesh,
from the same (JAX-initialised) params, within rtol 1e-5 (loss and
params); 2-rank ``sharded_collect`` equals ``get_rollouts`` of the whole
batch, exactly, with each rollout array a DTensor sharded on dim 0;
``make_mesh`` gives 1- and 2-axis meshes, and the step over both axes
equals the step over one.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import parallel as jparallel
from mujoco_mbrl_tpu_torch import convert, parallel
from mujoco_mbrl_tpu_torch.models import MLPDynamics, train
from mujoco_mbrl_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
WORKER_TIMEOUT = 240          # seconds, each subprocess

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from mujoco_mbrl_tpu_torch import convert, envs, parallel
from mujoco_mbrl_tpu_torch.models import MLPDynamics, train

rank, world, port, inp, out = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
parallel.distributed_init(f'localhost:{port}', world, rank, device='cpu')
res = {'world': dist.get_world_size(), 'backend': dist.get_backend()}
mesh = parallel.make_mesh(('env',))
mesh2 = parallel.make_mesh(('host', 'env'))
res['mesh'] = [list(mesh.shape), list(mesh2.shape), list(mesh2.mesh_dim_names)]

w = envs.load('cartpole', 'swingup', device='cpu')
collect = parallel.sharded_collect(mesh, w, 8, 3)
rolls = collect(torch.Generator().manual_seed(3))
ref = w.get_rollouts(torch.Generator().manual_seed(3), 8, 3)
res['collect'] = {}
for f in ('states', 'observations', 'actions', 'rewards'):
    x = getattr(rolls, f)
    assert isinstance(x, DTensor) and list(x.placements) == [Shard(0)], f
    assert x.to_local().shape[0] == 8 // world
    res['collect'][f] = float((x.full_tensor() - getattr(ref, f)).abs().max())

data = np.load(inp)
batch = {k: torch.tensor(data[k]) for k in ('states', 'actions', 'rewards',
                                            'next_states')}
model = MLPDynamics(4, 2, hidden_units=16)
for name, m_, axis in (('env', mesh, 'env'),
                       ('host_env', mesh2, ('host', 'env'))):
    params = convert.mlp_params({l: {k: data[f'{l}_{k}'] for k in ('w', 'b')}
                                 for l in ('l1', 'l2', 'l3')})
    step = parallel.dp_train_step(m_, model, train.sgd(0.1), axis=axis)
    params, opt, loss = step(params, None, batch)
    res[name] = {'loss': float(loss), 'params': {
        f'{l}_{k}': params[l][k].detach().numpy().tolist()
        for l in ('l1', 'l2', 'l3') for k in ('w', 'b')}}
json.dump(res, open(f'{out}_{rank}.json', 'w'))
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_workers(tmp_path, world, inp):
    script = tmp_path / 'worker.py'
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    port, out = _free_port(), str(tmp_path / 'out')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(port),
         str(inp), out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.load(open(f'{out}_{r}.json')) for r in range(world)]


@pytest.fixture(scope='module')
def problem(tmp_path_factory):
    """JAX-initialised MLP params and a global batch of 8, as numpy."""
    model = jmodels.MLPDynamics(4, 2, hidden_units=16)
    params = model.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    B = 8
    batch = dict(
        states=jax.random.normal(key, (B, 1, 4)),
        actions=jax.random.normal(jax.random.fold_in(key, 1), (B, 1, 2)),
        rewards=jnp.zeros((B, 1)),
        next_states=jax.random.normal(jax.random.fold_in(key, 2),
                                      (B, 1, 4)))
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    arrays.update({f'{l}_{k}': np.asarray(params[l][k])
                   for l in ('l1', 'l2', 'l3') for k in ('w', 'b')})
    path = tmp_path_factory.mktemp('dp') / 'problem.npz'
    np.savez(path, **arrays)
    return model, params, batch, arrays, path


def _single_process_step(arrays):
    """The port's full-batch SGD step on one process, no mesh."""
    model = MLPDynamics(4, 2, hidden_units=16)
    params = convert.mlp_params({l: {k: arrays[f'{l}_{k}'] for k in
                                     ('w', 'b')} for l in ('l1', 'l2', 'l3')})
    leaves = train.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = train.sgd(0.1)(leaves)
    batch = {k: torch.tensor(arrays[k]) for k in ('states', 'actions',
                                                  'rewards', 'next_states')}
    loss = model.loss(params, batch)
    loss.backward()
    opt.step()
    return float(loss.detach()), {
        f'{l}_{k}': params[l][k].detach().numpy()
        for l in ('l1', 'l2', 'l3') for k in ('w', 'b')}


def _jax_dp_step(problem):
    model, params, batch, _, _ = problem
    mesh = jparallel.make_mesh(('env',), devices=jax.devices()[:2])
    opt = optax.sgd(0.1)
    step = jparallel.dp_train_step(mesh, model, opt)
    p, _, loss = step(params, opt.init(params), batch)
    return float(loss), {f'{l}_{k}': np.asarray(p[l][k])
                         for l in ('l1', 'l2', 'l3') for k in ('w', 'b')}


def test_two_gloo_ranks_match_one_process_and_jax(problem, tmp_path):
    assert len(jax.devices()) >= 2
    _, _, _, arrays, path = problem
    results = run_workers(tmp_path, 2, path)
    loss1, p1 = _single_process_step(arrays)
    jloss, jp = _jax_dp_step(problem)
    np.testing.assert_allclose(loss1, jloss, rtol=RTOL)
    for r in results:
        assert r['world'] == 2 and r['backend'] == 'gloo'
        assert r['mesh'] == [[2], [1, 2], ['host', 'env']]
        for f, err in r['collect'].items():
            assert err == 0.0, (f, err)
        for name in ('env', 'host_env'):
            np.testing.assert_allclose(r[name]['loss'], loss1, rtol=RTOL)
            for k, v in r[name]['params'].items():
                np.testing.assert_allclose(np.asarray(v), p1[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
                np.testing.assert_allclose(np.asarray(v), jp[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
    # replicated: both ranks hold the same params
    assert results[0]['env']['params'] == results[1]['env']['params']


def test_one_rank_is_the_unsharded_run(problem, tmp_path):
    """World size 1: the mesh has one device, the collect is
    ``get_rollouts`` and the step the single-process step."""
    _, _, _, arrays, path = problem
    (r,) = run_workers(tmp_path, 1, path)
    assert r['mesh'] == [[1], [1, 1], ['host', 'env']]
    assert all(err == 0.0 for err in r['collect'].values())
    loss1, p1 = _single_process_step(arrays)
    np.testing.assert_allclose(r['env']['loss'], loss1, rtol=1e-6)
    for k, v in r['env']['params'].items():
        np.testing.assert_allclose(np.asarray(v), p1[k], rtol=1e-6,
                                   atol=1e-7)


def test_init_without_a_coordinator_is_a_no_op():
    import torch.distributed as dist
    parallel.distributed_init(None)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='distributed_init'):
        parallel.make_mesh(('env',))


def test_distributed_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA'):
        parallel.distributed_init('localhost:1', 1, 0)


def test_phase_timer_and_trace(tmp_path):
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase('collect', sync=True):
            torch.ones(64).sum()
    with timer.phase('fit'):
        pass
    s = timer.summary()
    assert s['collect']['count'] == 3 and s['fit']['count'] == 1
    assert s['collect']['total_s'] >= s['collect']['mean_s'] > 0
    with profiling.trace(str(tmp_path / 'trace')):
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    files = os.listdir(tmp_path / 'trace')
    assert len(files) == 1 and files[0].endswith('.json')
    events = json.load(open(tmp_path / 'trace' / files[0]))['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)
