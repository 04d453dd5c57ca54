"""Every configuration, workload and metric file loads, and BENCHMARK.json
names only what the files provide."""

import json
import os

import pytest

import harness

ROOT = os.path.dirname(harness.HERE)


def _bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def metric_names():
    """Every per-layer metric that has a reader in ``metrics/``."""
    return _names('metrics', '.py')


def _names(kind, ext='.json'):
    return sorted(f[:-len(ext)] for f in os.listdir(
        os.path.join(harness.HERE, kind))
        if f.endswith(ext) and not f.startswith('_'))


@pytest.mark.parametrize('name', _names('configs'))
def test_config_loads(name):
    cfg = harness.load_json('configs', name)
    assert cfg['name'] == name
    assert cfg['precision'] in ('float32',)
    for key in ('candidates', 'horizon', 'cem_iters', 'elites', 'sampler'):
        assert key in cfg['planner']


@pytest.mark.parametrize('name', _names('workloads'))
def test_workload_loads(name):
    wl = harness.load_json('workloads', name)
    harness.load_json('configs', wl['config'])
    harness.load_module('traffic', wl['traffic'])
    assert wl['chips'] in (1, 4)
    for metric in wl['metrics'] + wl['metrics_trace']:
        if metric != 'setup_s':
            assert metric in metric_names()
    for limit in wl['limits'].values():
        assert isinstance(limit, (int, float)) and limit >= 0


@pytest.mark.parametrize('name', metric_names())
def test_metric_reader_loads(name):
    reader = harness.load_module('metrics', name)
    assert isinstance(reader.UNIT, str) and callable(reader.read)


def test_benchmark_json_matches_the_files():
    bench = _bench()
    assert bench['paths'] == ['portbench']
    cells = {w['name']: w for w in bench['workloads']}
    assert set(cells) <= set(_names('workloads'))
    for c in bench['configs']:
        assert os.path.exists(os.path.join(ROOT, c['file']))
    readers = set(metric_names())
    for kind, key in (('end_to_end', 'metrics'),
                      ('per_layer', 'metrics_trace')):
        for m in bench[kind]:
            if m['name'] != 'setup_s':
                assert m['name'] in readers
                reader = harness.load_module('metrics', m['name'])
                assert reader.UNIT == m['unit']
            listed = m.get('workloads', list(cells))
            for cell in cells:
                wl = harness.load_json('workloads', cell)
                assert (m['name'] in wl[key]) == (cell in listed), (
                    m['name'], cell)
    e2e = {m['name'] for m in bench['end_to_end']}
    for m in bench['per_layer']:
        assert m['moves'] in e2e


def test_paths_hold_only_the_benchmark():
    bench = _bench()
    for word in bench['command']:
        assert not word.startswith('/') and '..' not in word
