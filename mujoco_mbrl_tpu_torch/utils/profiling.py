"""Profiling: torch.profiler traces + phase timers.

Port of mujoco_mbrl_tpu/utils/profiling.py: ``trace(logdir)`` records a
torch.profiler trace of the host and, where a card is present, of the
device (CUPTI), and writes it to ``logdir`` as a Chrome / Perfetto trace;
``PhaseTimer`` aggregates wall-clock per named phase of the MBRL loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record a torch.profiler trace of the block into
    ``<logdir>/trace_<pid>_<n>.json`` (view in Perfetto or
    chrome://tracing); yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        n = sum(f.startswith(f'trace_{os.getpid()}_')
                for f in os.listdir(logdir))
        prof.export_chrome_trace(
            os.path.join(logdir, f'trace_{os.getpid()}_{n}.json'))


class PhaseTimer:
    """Aggregating wall-clock timer for loop phases.

        timer = PhaseTimer()
        with timer.phase('collect', sync=True):
            ...
        timer.summary() -> {'collect': {'total_s': ..., 'count': ...}}

    ``sync=True`` waits for the card's pending work
    (``torch.cuda.synchronize``) before it stops the clock, where a card
    is present, so the phase's time includes its device work.
    """

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {'total_s': self._total[k], 'count': self._count[k],
                    'mean_s': self._total[k] / max(self._count[k], 1)}
                for k in self._total}
