"""What every cell shares: finding files by name, the window's arithmetic,
host spans, the reduction of a device trace, and the check that no JAX
module was loaded.

Nothing here knows a configuration, a traffic mix or a metric by name:
``run.py`` finds those as files under this directory.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'mujoco_mbrl_tpu')


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's directory."""
    path = os.path.join(HERE, kind, f'{name}.json')
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's directory,
    loaded from its path (names may hold dots)."""
    path = os.path.join(HERE, kind, f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench_{kind}_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """Names in ``modules`` whose top-level name (before the first dot)
    is one of ``FORBIDDEN_MODULES``, compared whole."""
    return sorted(m for m in modules
                  if m.split('.', 1)[0] in FORBIDDEN_MODULES)


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1..99) by ``statistics.quantiles`` over 100
    parts, inclusive method."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method='inclusive')[q - 1]


def step_times(event_ms: Sequence[float]) -> List[float]:
    """Per-step ms from the elapsed times of events recorded at the window's
    start and at each step's end, each measured from the start event."""
    out, prev = [], 0.0
    for t in event_ms:
        out.append(t - prev)
        prev = t
    return out


class Tracer:
    """Host spans around the calls into each layer, in one of three modes.
    ``off``: a span is free. ``mark``: a span only marks its interval in
    the profiler's trace as ``portbench.<name>``, so that the device trace
    shows the timed path's own schedule. ``time``: a span synchronizes the
    device before and after its body, so that its host-clock time, kept
    in ``spans``, holds its device work."""

    MODES = ('off', 'mark', 'time')

    def __init__(self, mode: str = 'off', sync=None):
        assert mode in self.MODES, mode
        self.mode = mode
        self._sync = sync or (lambda: None)
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.mode == 'off':
            yield
            return
        from torch.profiler import record_function
        if self.mode == 'mark':
            with record_function(f'portbench.{name}'):
                yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.spans[name].append(time.perf_counter() - t0)


def union_seconds(intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def idle_gaps(intervals: Sequence[Tuple[int, int]], t0: int, t1: int
              ) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of each stretch of [t0, t1] with no device op."""
    gaps, cursor = [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
        if cursor >= t1:
            break
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(a, b) for a, b in gaps if b > a]


def open_span(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The innermost host span open at ``t`` (the shortest that holds
    it), or 'host' where none is."""
    best, width = 'host', None
    for name, s, e in spans:
        if s <= t <= e and (width is None or e - s < width):
            best, width = name, e - s
    return best


class DeviceTrace:
    """The device operations and host spans of one profiled stretch:
    ``ops`` (name, start_ns, end_ns), ``spans`` (name, start_ns, end_ns)
    for the ``portbench.*`` annotations, the stretch ``[t0, t1]``, and
    ``launched`` (the host time at which each op was launched, or None
    where the trace does not link it to its launch)."""

    def __init__(self, ops, spans, t0: int, t1: int, units: int,
                 launched=None):
        self.ops = ops
        self.spans = spans
        self.t0, self.t1 = t0, t1
        self.units = units
        self.launched = launched or [None] * len(ops)

    @classmethod
    def from_profiler(cls, prof, units: int) -> 'DeviceTrace':
        ops, spans, corr, launch_at = [], [], [], {}
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            on_device = 'CUDA' in str(ev.device_type())
            if name.startswith('portbench.'):
                # the device's copy of a host annotation is no operation
                if not on_device:
                    spans.append((name[len('portbench.'):], start, end))
            elif on_device:
                ops.append((name, start, end))
                corr.append(ev.correlation_id())
            elif name.startswith('cu'):
                # a call of the CUDA runtime or driver on the host (a
                # launch), linked to its device op by the correlation id
                # the CUDA tracer gives both
                launch_at[ev.correlation_id()] = start
        window = [s for s in spans if s[0] == 'window']
        if window:
            t0, t1 = window[0][1], window[0][2]
        else:
            t0 = min(s for _, s, _ in ops)
            t1 = max(e for _, _, e in ops)
        return cls(ops, [s for s in spans if s[0] != 'window'], t0, t1,
                   units, [launch_at.get(c) for c in corr])

    @property
    def linked(self) -> int:
        """The device ops linked to their launch on the host."""
        return sum(at is not None for at in self.launched)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        return union_seconds((max(s, self.t0), min(e, self.t1))
                             for _, s, e in self.ops
                             if e > self.t0 and s < self.t1)

    def ops_in(self, span_name: str) -> List[Tuple[str, int, int]]:
        """Device ops launched inside a host span of that name (an op the
        trace does not link to its launch: one that starts inside it)."""
        iv = sorted((s, e) for n, s, e in self.spans if n == span_name)
        out = []
        for op, at in zip(self.ops, self.launched):
            t = op[1] if at is None else at
            if any(s <= t <= e for s, e in iv):
                out.append(op)
        return out

    def kernels(self, ops=None) -> List[Tuple[str, int, int]]:
        """The kernels among ``ops`` (default: all device ops): every
        device op but the copies and fills."""
        return [op for op in (self.ops if ops is None else ops)
                if not op[0].startswith(('Memcpy', 'Memset'))]

    def kernel_seconds(self, substring: str) -> Tuple[float, int]:
        """Summed seconds and count of device ops whose name holds
        ``substring``."""
        hits = [(e - s) for n, s, e in self.ops if substring in n]
        return sum(hits) * 1e-9, len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time (by name), and the idle time
        by the host span open in the middle of each gap."""
        by_op: Dict[str, int] = defaultdict(int)
        for n, s, e in self.ops:
            by_op[n] += e - s
        by_gap: Dict[str, int] = defaultdict(int)
        for a, b in idle_gaps([(s, e) for _, s, e in self.ops],
                              self.t0, self.t1):
            by_gap[open_span(self.spans, (a + b) // 2)] += b - a
        rank = lambda d: [[k, v * 1e-9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': rank(by_op), 'idle_gaps': rank(by_gap)}


def finite(x: Optional[float]) -> bool:
    return x is not None and math.isfinite(x)


def emit(result: dict, checks: List[Tuple[str, float, float]]) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output, with the
    same numbers under ``checks``, its last key."""
    for name, value, limit in checks:
        print(f'check {name} {value!r} limit {limit!r}', file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in checks}
    print(json.dumps(result), flush=True)
