"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file ``workloads/<name>.json`` names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.py``);
each per-layer metric is read by ``metrics/<metric>.py``. The run sets up
the cell (the set-up's seconds are ``setup_s``), measures for ``--seconds``
seconds, judges what the window produced against the plain reference in
``reference/``, and prints one JSON line last. ``--trace 1`` first takes
the device trace of a few units, whose host spans around each layer's
call only mark the trace, then measures the same window with those spans
synchronized and timed, and reports the per-layer metrics instead of the
end-to-end ones.

It needs the port (``mujoco_mbrl_tpu_torch``) beside it and a CUDA card;
without either it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels into ``mujoco_mbrl_tpu_torch/_build``
    beside its sources; the rest is pointed here."""
    base = os.path.join(ROOT, '.portbench_cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'nv_compute')):
        os.environ[var] = os.path.join(base, sub)


def steady_host() -> None:
    """One core and one CPU thread for the whole run: the process, and
    every thread it starts, pinned to the last core it may use, and
    PyTorch's CPU pools held to one thread. The timed path is bound by
    the host's issue of small kernels, so a run that the scheduler moves
    between cores, or whose CPU pool wakes on every core, spreads more."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[-1]})
    os.environ['OMP_NUM_THREADS'] = '1'


def run(args, device, overrides=None, program=None, sync=None):
    """Set up the cell, run its window and judge it. Returns the result
    (without ``checks``) and the checks [(name, reading, limit)].
    ``overrides`` replaces keys of the workload (tests shrink a cell with
    it); ``program`` replaces the port's control step (the control and
    the fault tests hand theirs in)."""
    import torch

    import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = dict(overrides or {})
    cfg_parts = {k: overrides.pop(k) for k in ('planner',)
                 if k in overrides}
    wl = harness.load_json('workloads', args.workload)
    wl.update(overrides)
    cfg = harness.load_json('configs', wl['config'])
    for k, v in cfg_parts.items():
        cfg[k].update(v)
    traffic = harness.load_module('traffic', wl['traffic'])
    on_card = device.type == 'cuda'
    sync = sync or ((lambda: torch.cuda.synchronize(device)) if on_card
                    else (lambda: None))
    tracer = harness.Tracer('off', sync)
    cell = traffic.Cell(cfg, wl, args.seed, device, tracer, program=program)
    sync()
    setup_s = time.perf_counter() - T_START

    trace = None
    if args.trace:
        # the device trace of the first units, whose spans only mark the
        # trace; then the window, whose spans synchronize and are timed
        tracer.mode = 'mark'
        trace = profiled_units(cell, int(wl['trace_units']), sync, on_card)
        tracer.mode = 'time'
    units, unit_ms, window_s = window(cell, args.seconds, sync, on_card)
    tracer.mode = 'off'
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = cell.check()

    ctx = dict(cfg=cfg, wl=wl, cell=cell, spans=tracer.spans, trace=trace,
               units=units, unit_ms=unit_ms, window_s=window_s)
    names = wl['metrics_trace'] if args.trace else wl['metrics']
    metrics = {}
    for name in names:
        if name == 'setup_s':
            metrics[name] = {'value': setup_s, 'unit': 's'}
            continue
        reader = harness.load_module('metrics', name)
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {'value': value, 'unit': reader.UNIT}
    device_info = {
        'platform': 'gpu' if on_card else 'cpu',
        'kind': (torch.cuda.get_device_name(device) if on_card
                 else 'cpu'),
        'count': 1,
        'memory_peak_bytes': peak,
    }
    result = {
        'correct': all(harness.finite(v) and v <= lim
                       for _, v, lim in checks),
        'attempted': units,
        'failed': sum(1 for _, v, lim in checks
                      if not (harness.finite(v) and v <= lim)),
        'metrics': metrics,
        'device': device_info,
    }
    if trace is not None:
        device_info['busy_s'] = trace.busy_s()
        device_info['window_s'] = trace.window_s
        result['breakdown'] = trace.breakdown()
    return result, checks


def window(cell, seconds: float, sync, on_card: bool):
    """Run whole units until ``seconds`` have passed; the window ends with
    a synchronize after the last. Returns the units run, each unit's ms
    (CUDA events recorded at each unit's end, read after the window) and
    the window's seconds."""
    import torch
    events = []
    start = torch.cuda.Event(enable_timing=True) if on_card else None
    sync()
    t0 = time.perf_counter()
    if on_card:
        start.record()
    units, host_ends = 0, []
    while True:
        cell.step()
        units += 1
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_ends.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    import harness
    if on_card:
        ends = [start.elapsed_time(ev) for ev in events]
    else:
        ends = [(t - t0) * 1e3 for t in host_ends]
    return units, harness.step_times(ends), window_s


def profiled_units(cell, n: int, sync, on_card: bool):
    """Run ``n`` units under the profiler, inside one ``portbench.window``
    span, with no synchronize but the one that ends it; returns their
    DeviceTrace (None off the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import harness
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function('portbench.window'):
            for _ in range(n):
                cell.step()
            sync()
    if not on_card:
        return None
    trace = harness.DeviceTrace.from_profiler(prof, n)
    del prof
    print(f'portbench: trace of {n} units: {len(trace.ops)} device ops, '
          f'{trace.linked} linked to their launch', file=sys.stderr)
    return trace


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs()
    steady_host()
    import torch
    torch.set_num_threads(1)
    import harness
    wl = harness.load_json('workloads', args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(wl['chips'])):
        print(f'portbench: the cell needs {wl["chips"]} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    result, checks = run(args, device)
    loaded = harness.forbidden_loaded(sys.modules)
    if loaded:
        print('portbench: modules that may not load in a run were loaded: '
              + ', '.join(loaded), file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
