"""The benchmark's own tests. They run on the CPU with the port's plain
versions at tiny sizes; those marked ``cuda`` need the card and skip
without one (run them on the card with
``python3 -m pytest portbench/tests -m cuda``)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

# a tiny cell: few envs, candidates and horizon steps, on the CPU
TINY = {'envs': 6, 'check': {'envs': 3, 'physics_steps': 2},
        'planner': {'candidates': 20, 'horizon': 4, 'elites': 4}}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA CUDA card; skipped without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
