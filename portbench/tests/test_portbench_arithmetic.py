"""The window, percentile and idle-share arithmetic on synthetic events."""

import pytest

import harness


def test_step_times_from_cumulative_events():
    assert harness.step_times([10.0, 25.0, 27.5]) == [10.0, 15.0, 2.5]


def test_percentile_is_the_inclusive_quantile():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 90) == pytest.approx(90.1)
    assert harness.percentile([3.0], 90) == 3.0


def test_union_and_gaps():
    ops = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert harness.union_seconds(ops) == pytest.approx(30e-9)
    assert harness.idle_gaps(ops, 0, 50) == [(20, 30), (40, 50)]
    assert harness.idle_gaps(ops, -5, 15) == [(-5, 0)]


def test_device_trace_shares_and_breakdown():
    ops = [('k_plan', 100, 200), ('k_phys', 250, 260), ('k_phys', 270, 280),
           ('memcpy', 290, 300)]
    spans = [('plan', 90, 210), ('physics', 240, 300), ('step', 90, 300)]
    tr = harness.DeviceTrace(ops, spans, 100, 300, units=2)
    assert tr.window_s == pytest.approx(200e-9)
    assert tr.busy_s() == pytest.approx(130e-9)
    assert len(tr.ops_in('physics')) == 3
    assert tr.kernel_seconds('k_phys') == (pytest.approx(20e-9), 2)
    b = tr.breakdown()
    assert b['device_ops'][0] == ['k_plan', pytest.approx(100e-9)]
    # gaps: 200-250 (mid 225: inside 'step' only), 260-270 and 280-290
    # (inside 'physics', the innermost)
    assert dict((k, v) for k, v in b['idle_gaps']) == {
        'step': pytest.approx(50e-9), 'physics': pytest.approx(20e-9)}


def test_ops_are_placed_in_spans_by_their_launch():
    # without a synchronize the device runs behind the host: an op launched
    # inside 'physics' may start after the span has closed
    ops = [('k_phys', 400, 410), ('k_plan', 420, 430), ('k_free', 250, 260)]
    spans = [('physics', 100, 200), ('plan', 300, 350)]
    tr = harness.DeviceTrace(ops, spans, 100, 450, units=1,
                             launched=[150, 320, None])
    assert [op[0] for op in tr.ops_in('physics')] == ['k_phys']
    assert [op[0] for op in tr.ops_in('plan')] == ['k_plan']
    # an op with no launch linked is placed by its start
    tr = harness.DeviceTrace(ops, spans, 100, 450, units=1)
    assert tr.ops_in('physics') == []


@pytest.mark.parametrize('mode, timed', [('off', False), ('mark', False),
                                         ('time', True)])
def test_tracer_times_and_synchronizes_only_in_time_mode(mode, timed):
    calls = []
    tr = harness.Tracer(mode, lambda: calls.append('sync'))
    with tr.span('plan'):
        pass
    assert ('plan' in tr.spans) == timed
    assert calls == (['sync', 'sync'] if timed else [])


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    found = harness.forbidden_loaded(
        ['jax', 'jax.numpy', 'jaxlib.xla', 'flax', 'mujoco_mbrl_tpu',
         'mujoco_mbrl_tpu.physics', 'mujoco_mbrl_tpu_torch',
         'mujoco_mbrl_tpu_torch.ops', 'jaxtyping', 'numpy'])
    assert found == ['flax', 'jax', 'jax.numpy', 'jaxlib.xla',
                     'mujoco_mbrl_tpu', 'mujoco_mbrl_tpu.physics']
