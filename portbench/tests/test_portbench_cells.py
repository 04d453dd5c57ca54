"""Whole runs of each cell on the CPU at a tiny size, with the port's plain
versions: the reference agrees with the port; each fault planted in the
timed path (``faults.py``) turns ``correct`` false; a workload added as a
file is found; and the command refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import harness
import run
import faults
from conftest import TINY

CPU = torch.device('cpu')
CELLS = ['walker_walk.mpc.b4096', 'cheetah_run.mpc.b4096']
# statistics of the draws, which sound runs read as a z-score and a share
# of chance repeats, not as a rounding gap
DRAW_STATS = ('noise_z', 'noise_repeat')


def _run(cell, program=None, overrides=None, seed=1234567890123):
    args = run.parse_args(['--workload', cell, '--seed', str(seed),
                           '--seconds', '0.01', '--trace', '0'])
    over = dict(overrides or TINY)
    return run.run(args, CPU, overrides=over, program=program)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('size', ['tiny', 'draws'])
def test_reference_agrees_with_the_port(cell, size):
    result, checks = _run(cell, overrides=TINY if size == 'tiny' else DRAWS)
    assert result['correct'], checks
    assert result['attempted'] >= 1
    for name, value, limit in checks:
        share = 2 if name in DRAW_STATS else 10
        assert value <= limit / share or value == limit == 0, (name, value)


# the draw faults change the law of the candidates, which a few hundred
# draws an env cannot tell apart: they run with more candidates and steps
DRAWS = dict(TINY, planner={'candidates': 500, 'horizon': 20,
                            'elites': 50})


@pytest.mark.parametrize('fault', faults.STEP_FAULTS + faults.DRAW_FAULTS,
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('cell', CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    base = DRAWS if fault in faults.DRAW_FAULTS else TINY
    # every env checked, so that the envs a fault touches are among them
    over = dict(base, check={'envs': base['envs'], 'physics_steps': 2})
    cfg = harness.load_json('configs',
                            harness.load_json('workloads', cell)['config'])
    result, checks = _run(cell, program=fault(cfg, CPU), overrides=over)
    assert not result['correct'], checks


def test_a_workload_added_as_a_file_is_found(tmp_path):
    copy = tmp_path / 'portbench'
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    wl = json.loads((copy / 'workloads' / 'walker_walk.mpc.b4096.json')
                    .read_text())
    wl['envs'] = 5
    (copy / 'workloads' / 'walker_walk.mpc.tiny.json').write_text(
        json.dumps(wl))
    code = (
        'import sys, torch; sys.path.insert(0, sys.argv[1]); import run; '
        "a = run.parse_args(['--workload', 'walker_walk.mpc.tiny', "
        "'--seed', '7', '--seconds', '0.01', '--trace', '0']); "
        'r, c = run.run(a, torch.device("cpu"), overrides={"planner": '
        '{"candidates": 20, "horizon": 4, "elites": 4}, "check": '
        '{"envs": 2, "physics_steps": 1}}); '
        "print(r['correct'], r['attempted'])")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(harness.HERE),
               OMP_NUM_THREADS='2')
    out = subprocess.run([sys.executable, '-c', code, str(copy)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2] == 'True'


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, 'run.py'), '--workload',
         CELLS[0], '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
