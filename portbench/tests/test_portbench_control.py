"""The control of ``correct`` on the card: the plain reference in the
program's place, its matrix products in TF32 and the rest in bfloat16
(``control.py``), has to come out not correct in every cell. At the
cells' own sizes it is run by ``python3 portbench/control.py``; here at a
size a test run holds. So are the faults of the sampler's draws
(``faults.DRAW_FAULTS``) with the CUDA kernel underneath."""

import pytest

import harness
from conftest import TINY

CELLS = ['walker_walk.mpc.b4096', 'cheetah_run.mpc.b4096']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_is_not_correct(cell, card):
    import control
    small = dict(TINY, envs=256,
                 check={'envs': 16, 'physics_steps': 4})
    small['planner'] = {'candidates': 200, 'horizon': 30, 'elites': 20}
    checks = control.readings(cell, 1234567891, 2.0, card, overrides=small)
    assert any(not harness.finite(v) or v > lim for _, v, lim in checks), \
        checks


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['MeanOnly', 'StdIgnored', 'EnvsShareNoise',
                                   'CandidatesShareNoise', 'NoMirror'])
def test_a_draw_fault_on_the_card_is_not_correct(fault, card):
    import control
    small = dict(TINY, envs=256, check={'envs': 16, 'physics_steps': 4})
    small['planner'] = {'candidates': 200, 'horizon': 30, 'elites': 20}
    checks = control.readings('cheetah_run.mpc.b4096', 1234567893, 2.0,
                              card, overrides=small, program=fault)
    assert any(not harness.finite(v) or v > lim for _, v, lim in checks), \
        checks
