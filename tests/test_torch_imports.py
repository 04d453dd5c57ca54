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


# ---- name-level parity: what each JAX module defines, its port has ------
#
# Every public top-level function, class and assignment of a JAX module
# (and, in a package's __init__.py, each name it imports from its own
# modules: its entry-point names), every public method and class
# attribute of a public class, and every keyword of a public function or
# method (constructors included) must be found on the port's module of
# the same path. Other imports are not counted. The names the port lacks
# or renames on purpose stand below, each with its reason, by kind.

_JAX_ROOT = os.path.join(ROOT, 'mujoco_mbrl_tpu')

# (module, name) or (module, function, keyword); 'Class.method' for a method
_TPU_LAYOUT = {
    ('ops.apgd_solve', 'ENVS_PER_PROGRAM'):
        'envs one Pallas program holds; a CUDA warp or block holds one',
    ('ops.apgd_solve', 'MAX_NR'):
        'rows the VMEM-resident kernel holds; dense_route picks a CUDA path',
    ('ops.apgd_solve', 'factored_fits'):
        'whether J~ and M^-1 fit the ~16 MB of VMEM',
    ('ops.apgd_solve', 'apgd_iterate_batched', 'interpret'):
        'Pallas interpret mode; a CPU tensor takes the plain version',
    ('ops.apgd_solve', 'apgd_iterate_factored', 'interpret'):
        'Pallas interpret mode; a CPU tensor takes the plain version',
    ('ops.cem_rollout', 'mlp_rollout_costs', 'tile'):
        'candidates a Pallas grid step holds',
    ('ops.cem_rollout', 'mlp_rollout_costs', 'interpret'):
        'Pallas interpret mode; a CPU tensor takes the plain version',
    ('ops.cem_rollout', 'mlp_rollout_costs_t', 'tile'):
        'candidates a Pallas grid step holds',
    ('ops.cem_rollout', 'mlp_rollout_costs_t', 'interpret'):
        'Pallas interpret mode; a CPU tensor takes the plain version',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs', 'interpret'):
        'Pallas interpret mode; a CPU tensor takes the plain version',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs', 'envs_per_program'):
        'envs a Pallas program interleaves on its 128 lanes',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs', 'unroll'):
        'the Mosaic horizon loop\'s unroll',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs', 'return_padded'):
        'costs left padded to 128 lanes; the CUDA kernel writes K',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs_ensemble', 'unroll'):
        'the Mosaic horizon loop\'s unroll',
    ('ops.cem_rollout', 'mlp_sample_rollout_costs_ensemble',
     'return_padded'):
        'costs left in the K-major lane layout; the CUDA kernel writes K',
}
_BATCHED_API = {
    ('agents.mpc', 'BatchedMPCPolicy.__init__', 'num_envs'):
        'the env count is the planned states\' leading dimension',
    ('planners.shooting', 'cem_batched', 'key'):
        '`seeds`: one sampler seed an iteration',
    ('planners.shooting', 'cem_batched', 'num_iterations'):
        '`seeds`: one sampler seed an iteration',
}
# JAX's keyword -> the port's, wherever a JAX function takes it
_BATCHED_RENAMES = {
    'key': ('generator', 'an explicit torch.Generator replaces the PRNG key'),
    'initial_state': ('initial_states', 'one initial state an env, (B, sd)'),
}
_JAX_IGNORES = {
    ('suite.sensors', 'touch', 'geom_id'):
        'accepted and never read (suite/sensors.py:77-78)',
    ('suite.sensors', 'touch', 'radius'):
        'accepted and never read (suite/sensors.py:77-78)',
    ('models.train', 'train_model', 'normalize_targets'):
        'never read (models/train.py:74-114)',
    ('models.train', 'train_model', 'opt_state'):
        'a torch.optim optimizer holds its own state',
    **{('physics.engine', fn, 'contact_fn'):
       'threaded to _forward, which never reads it (engine.py:96-101)'
       for fn in ('forward', 'step', 'step_warm', 'substep')},
}
_NOT_PORTED = {**_TPU_LAYOUT, **_BATCHED_API, **_JAX_IGNORES}


def _jax_modules():
    out = []
    for dp, _, fs in os.walk(_JAX_ROOT):
        for f in fs:
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(dp, f), _JAX_ROOT)[:-3]
                out.append(rel.replace(os.sep, '.'))
    return sorted(out)


def _top_level(body):
    """Module statements, those under a top-level if / try included."""
    import ast
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body)
            for h in getattr(node, 'handlers', ()):
                yield from _top_level(h.body)
            yield from _top_level(node.orelse)
        else:
            yield node


def _assigned(node):
    import ast
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target] if isinstance(node, ast.AnnAssign) else [])
    for t in targets:
        for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(n, ast.Name):
                yield n.id


def _keywords(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ('self', 'cls')]


def _public_surface(rel):
    """[(name, kind, node)] of the JAX module `rel`: kind 'def' for a
    top-level function or class or a re-export, 'method' / 'attr' for a
    class member ('Class.member')."""
    import ast
    path = os.path.join(_JAX_ROOT, rel.replace('.', os.sep) + '.py')
    tree = ast.parse(open(path).read())
    is_init = rel.endswith('__init__')
    out = []
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith('_'):
                continue
            out.append((node.name, 'def', node))
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if isinstance(b, ast.FunctionDef) and (
                            b.name == '__init__'
                            or not b.name.startswith('_')):
                        out.append((f'{node.name}.{b.name}', 'method', b))
                    for n in _assigned(b):
                        if not n.startswith('_'):
                            out.append((f'{node.name}.{n}', 'attr', None))
        elif isinstance(node, ast.ImportFrom) and is_init and node.level:
            out += [(a.asname or a.name, 'def', None) for a in node.names
                    if a.name != '*' and not a.name.startswith('_')]
        else:
            out += [(n, 'def', None) for n in _assigned(node)
                    if not n.startswith('_')]
    return out


def _lookup(obj, dotted):
    for part in dotted.split('.'):
        fields = getattr(obj, '__dataclass_fields__', None) or ()
        if not hasattr(obj, part) and (part in fields
                                       or part in getattr(obj, '_fields',
                                                          ())):
            return True
        obj = getattr(obj, part)
    return obj


def test_not_ported_names_are_tpu_layout_batched_api_or_ignored():
    """Every allowlisted entry names a JAX name or keyword that exists and
    that the port indeed lacks, and carries its reason."""
    import ast
    surface = {rel: {n: node for n, _, node in _public_surface(rel)}
               for rel in _jax_modules()}
    for entry, reason in _NOT_PORTED.items():
        assert reason, entry
        mod, name = entry[0], entry[1]
        assert name in surface[mod], entry
        if len(entry) == 3:
            node = surface[mod][name]
            assert isinstance(node, ast.FunctionDef), entry
            assert entry[2] in _keywords(node), entry
    assert set(_BATCHED_RENAMES) == {'key', 'initial_state'}


@pytest.mark.parametrize('rel', _jax_modules())
def test_port_has_every_public_name_of_the_jax_module(rel):
    """The port's module of the same path defines every public name,
    method, class attribute and keyword of the JAX module, but for the
    TPU-layout, batched-API and JAX-ignored entries above."""
    import importlib
    import inspect
    mod = rel[:-len('.__init__')] if rel.endswith('__init__') else rel
    mod = '' if mod == '__init__' else mod
    port = importlib.import_module(
        'mujoco_mbrl_tpu_torch' + ('.' + mod if mod else ''))
    missing = []
    for name, kind, node in _public_surface(rel):
        if (mod, name) in _NOT_PORTED:
            continue
        try:
            obj = _lookup(port, name)
        except AttributeError:
            missing.append(name)
            continue
        if node is None or not hasattr(node, 'args') or obj is True:
            continue
        try:
            params = inspect.signature(obj).parameters
        except (TypeError, ValueError):        # a property
            continue
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            continue
        for kw in _keywords(node):
            if kw in params or (mod, name, kw) in _NOT_PORTED:
                continue
            if kw in _BATCHED_RENAMES and _BATCHED_RENAMES[kw][0] in params:
                continue
            missing.append(f'{name}({kw}=)')
    assert missing == [], f'mujoco_mbrl_tpu_torch.{mod}: {missing}'
