"""The bench entry point, ``python -m mujoco_mbrl_tpu_torch.bench``, on the
CPU.

``analytic_flops`` gives the JAX bench's FLOP counts (``bench.py``, the
JAX harness, imported here only) for every preset, as integers;
``mfu_report`` gives hand-computed shares against the H100 peaks;
``main`` with ``--cpu`` at tiny sizes prints the JAX bench's last JSON
line less ``vs_baseline`` for the control step, ``--dtype bf16``,
``--phases``, ``--agent-loop`` and a preset cut down by flags; ``--group``
and ``--unroll`` fail as JAX's argparse does; and without ``--cpu`` on a
machine with no CUDA device ``main`` exits non-zero: no CPU fallback.
"""

import json
import math

import pytest
import torch

import bench as jax_bench
from mujoco_mbrl_tpu_torch import bench

TINY = ['--cpu', '--envs', '4', '--candidates', '16', '--horizon', '4',
        '--steps', '2', '--repeats', '1']
STEP_KEYS = {'metric', 'value', 'unit', 'achieved_tflops_upper',
             'mfu_pct_bf16peak'}


@pytest.mark.parametrize('preset', sorted(bench.CONFIGS))
def test_analytic_flops_match_jax_bench(preset):
    c = bench.CONFIGS[preset]
    args = (c['task'], c['envs'], c['candidates'], c['horizon'], 3)
    ours, ref = bench.analytic_flops(*args), jax_bench.analytic_flops(*args)
    assert set(ours) == set(ref)
    for k in ref:
        assert int(round(ours[k])) == int(round(ref[k])), (k, ours, ref)


def test_mfu_report_against_h100_peaks():
    fl = {'plan_flops_per_ctrl_step': 9.894e11,
          'physics_flops_per_ctrl_step': 6.69e9}
    f32 = bench.mfu_report(fl, 0.01, 0.1)
    # 98.94 TFLOP/s of plan against TF32's 494.7, 0.0669 of physics
    # against FP32's 66.9
    assert f32 == {'plan_tflops': 98.94, 'plan_mfu_pct_tf32peak': 20.0,
                   'physics_tflops_upper': 0.07,
                   'physics_mfu_pct_f32peak': 0.1}
    bf16 = bench.mfu_report(fl, 0.01, None, torch.bfloat16)
    assert bf16 == {'plan_tflops': 98.94, 'plan_mfu_pct_bf16peak': 10.0}
    assert all('mfu' in k for k in {**f32, **bf16} if 'pct' in k)


def _last_json(capsys, argv):
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _step_line(rec):
    assert set(rec) == STEP_KEYS
    assert rec['unit'] == 'env-steps/s'
    assert math.isfinite(rec['value']) and rec['value'] > 0
    assert 'vs_baseline' not in rec


@pytest.mark.parametrize('extra', [['--task', 'walker_walk'],
                                   ['--task', 'walker_walk', '--dtype',
                                    'bf16'],
                                   ['--config', 'reacher256']])
def test_main_prints_the_step_line(capsys, extra):
    rec = _last_json(capsys, extra + TINY)
    _step_line(rec)
    assert '4 envs' in rec['metric']


def test_main_phases_line(capsys):
    rec = _last_json(capsys, ['--phases', '--task', 'reacher_easy'] + TINY)
    assert {'metric', 'plan_ms', 'plan_ms_per_cem_iter',
            'physics_ms_per_control_step', 'implied_env_steps_per_s',
            'plan_tflops', 'plan_mfu_pct_tf32peak', 'physics_tflops_upper',
            'physics_mfu_pct_f32peak', 'mfu_note'} == set(rec)
    assert rec['plan_ms'] > 0 and rec['physics_ms_per_control_step'] > 0


def test_main_agent_loop_line(capsys):
    rec = _last_json(capsys, ['--agent-loop', '--task', 'walker_walk']
                     + TINY)
    assert set(rec) == {'metric', 'value', 'unit'}
    assert 'GoalStateAgent' in rec['metric'] and rec['value'] > 0


@pytest.mark.parametrize('argv,message', [
    (['--group', '3', '--envs', '1024'],
     '--envs 1024 must be divisible by --group 3'),
    (['--unroll', '5'], '--unroll must be 1 or the full horizon (30)'),
    (['--group', '2', '--model', 'ensemble'],
     '--group > 1 is not supported with --model ensemble'),
])
def test_layout_flags_fail_as_in_jax(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_no_cuda_device_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    assert bench.main([]) != 0
    assert capsys.readouterr().out == ''
