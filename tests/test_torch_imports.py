"""The port stands alone: no JAX, no mujoco_mbrl_tpu, CUDA by default."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import mujoco_mbrl_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(mujoco_mbrl_tpu_torch.__file__)
_FORBIDDEN = re.compile(
    r'^\s*(import|from)\s+(jax|jaxlib|flax|mujoco_mbrl_tpu)\b(?!_)', re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix='mujoco_mbrl_tpu_torch.'))


def test_importing_every_module_loads_no_jax():
    code = (
        'import importlib, sys\n'
        f'for name in {_modules()!r}:\n'
        '    importlib.import_module(name)\n'
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mujoco_mbrl_tpu'))\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_modules()) > 20


@pytest.mark.parametrize('path', sorted(
    [os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
     if f.endswith('.py')] + [os.path.join(ROOT, 'chip_smoke.py')]))
def test_sources_import_no_jax(path):
    with open(path) as fh:
        src = fh.read()
    assert not _FORBIDDEN.search(src), path


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.bench import build_bench
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('walker', 'walk')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_bench('walker_walk', 2, 8, 3, 1, 1)
    with pytest.raises(RuntimeError, match='CUDA'):
        mujoco_mbrl_tpu_torch.resolve_device('cuda')
    assert mujoco_mbrl_tpu_torch.resolve_device('cpu').type == 'cpu'
    # the agent loop's entry points default to the card too
    from mujoco_mbrl_tpu_torch import agents, data, envs, experiment
    from mujoco_mbrl_tpu_torch import planners
    from mujoco_mbrl_tpu_torch.models import (EnsembleDynamics, MLPDynamics,
                                              train)
    from mujoco_mbrl_tpu_torch.ops import _build
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('walker', 'walk')
    with pytest.raises(RuntimeError, match='CUDA'):
        data.init_replay(4, 8, 20, 24, 6)
    with pytest.raises(RuntimeError, match='CUDA'):
        MLPDynamics(20, 6).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='CUDA'):
        EnsembleDynamics(MLPDynamics(20, 6), 5).init(
            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='CUDA'):
        agents.GoalStateAgent(
            environment=envs.load('walker', 'stand'),
            planner=planners.CEMPlanner, model=MLPDynamics(20, 6),
            horizon=4, optimizer=train.adam(), rollout_length=8,
            num_rollouts_per_iteration=2, num_train_iterations=1,
            writer=None, base_path='')
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'walker_walk']))
    # the ensemble sampler's card path: build_bench plans through it, and
    # without the CUDA toolkit its kernel cannot be built
    with pytest.raises(RuntimeError, match='CUDA'):
        build_bench('walker_walk', 2, 8, 3, 1, 1, model_kind='ensemble')
    with pytest.raises(RuntimeError, match='nvcc'):
        _build._nvcc()
    # the cheetah slice's entry points
    from mujoco_mbrl_tpu_torch.bench import full_loop_bench
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('cheetah', 'run')
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('cheetah', 'run')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_bench('cheetah_run', 2, 8, 3, 1, 1, fused=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        full_loop_bench('cheetah_run', 2, 8, 3, 1, 1)


# the tools around the engine: distributed execution, the model builder
# and physics utilities, rendering
_TOOLS = ('parallel', 'parallel.mesh', 'physics.named', 'physics.ik',
          'physics.schema', 'physics.debugging', 'physics.builder',
          'utils.profiling', 'utils.render', 'utils.raycast',
          'utils.recorder', 'suite.wrappers')


@pytest.mark.parametrize('name', _TOOLS)
def test_tool_module_is_ported(name):
    """Each module has its JAX counterpart, by the same name, and is
    among the modules the import test loads without JAX."""
    assert f'mujoco_mbrl_tpu_torch.{name}' in _modules()
    rel = name.replace('.', os.sep)
    assert (os.path.exists(os.path.join(ROOT, 'mujoco_mbrl_tpu', rel + '.py'))
            or os.path.isdir(os.path.join(ROOT, 'mujoco_mbrl_tpu', rel)))


def test_tool_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import envs, parallel
    from mujoco_mbrl_tpu_torch.physics import builder
    assert hasattr(envs.EnvWrapper, 'record_rollout')
    root = builder.RootElement(model='t')
    root.worldbody.add('body', name='b').add('geom', type='sphere',
                                             size=[0.1])
    with pytest.raises(RuntimeError, match='CUDA'):
        root.compile()
    assert root.compile(device='cpu').nbody == 2
    with pytest.raises(RuntimeError, match='CUDA'):
        parallel.distributed_init('localhost:1', 1, 0)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result,
    also from a directory holding nothing but the script."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    script = os.path.join(ROOT, 'chip_smoke.py')
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text(open(script).read())
    for path, cwd in ((script, ROOT), (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, path], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


_XML_COPIES = [(d, None) for d in ('acrobot', 'ball_in_cup', 'cheetah',
                                   'finger', 'hopper', 'humanoid',
                                   'pendulum', 'point_mass', 'reacher',
                                   'walker')] + [
    ('cartpole', n) for n in (1, 2, 3)] + [('swimmer', n) for n in (6, 15)] + [
    ('lqr', n) for n in ((2, 1), (6, 2))]


@pytest.mark.parametrize('domain,n', _XML_COPIES)
def test_model_xml_is_the_jax_modules_copy(domain, n):
    """Each ported domain keeps its own copy of the JAX module's model XML
    (or of its XML generator): the two give the same text."""
    import importlib
    ours = importlib.import_module(f'mujoco_mbrl_tpu_torch.suite.{domain}')
    ref = importlib.import_module(f'mujoco_mbrl_tpu.suite.{domain}')
    if n is None:
        assert ours._XML == ref._XML
    elif domain == 'lqr':
        import numpy as np
        assert ours._make_model_xml(*n, np.random.RandomState(3)) == \
            ref._make_model_xml(*n, np.random.RandomState(3))
    else:
        assert ours._make_model_xml(n) == ref._make_model_xml(n)


# the model-building stack and the viewer: the last JAX modules ported
_MODEL_BUILDING = ('composer', 'observation', 'variation', 'props',
                   'locomotion', 'locomotion.arenas', 'locomotion.walkers',
                   'locomotion.tasks', 'locomotion.soccer', 'viewer',
                   'suite.explore')


@pytest.mark.parametrize('name', _MODEL_BUILDING)
def test_model_building_module_is_ported(name):
    """Each has its JAX counterpart by the same name, is among the modules
    the import test loads without JAX, and its source imports none."""
    assert f'mujoco_mbrl_tpu_torch.{name}' in _modules()
    rel = name.replace('.', os.sep)
    jax_path = os.path.join(ROOT, 'mujoco_mbrl_tpu', rel)
    assert os.path.exists(jax_path + '.py') or os.path.isdir(jax_path)
    path = os.path.join(PKG, rel)
    path = (os.path.join(path, '__init__.py') if os.path.isdir(path)
            else path + '.py')
    with open(path) as fh:
        assert not _FORBIDDEN.search(fh.read()), path


def test_every_jax_module_has_a_counterpart():
    """The port has a module for every module of the JAX package."""
    jax_root = os.path.join(ROOT, 'mujoco_mbrl_tpu')
    missing = [os.path.relpath(os.path.join(dp, f), jax_root)
               for dp, _, fs in os.walk(jax_root) for f in fs
               if f.endswith('.py') and not os.path.exists(os.path.join(
                   PKG, os.path.relpath(os.path.join(dp, f), jax_root)))]
    assert missing == []
