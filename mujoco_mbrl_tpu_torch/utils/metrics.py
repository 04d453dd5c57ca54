"""Metrics writer: one JSON record per line in ``metrics.jsonl``.

The records are those of the JAX ``MetricsWriter``
(mujoco_mbrl_tpu/utils/metrics.py): scalars ``{t, tag, value, step}`` and
histograms ``{t, tag, step, hist: {mean, std, min, max, n}}``. With
``use_tensorboard`` the same scalars and histograms also go to TensorBoard
event files where torch's ``SummaryWriter`` imports, as in JAX; it is off
by default here, since that import takes seconds and the jsonl is the
record every reader of this package uses.
"""

from __future__ import annotations

import json
import os
import time
from typing import Sequence

import numpy as np
import torch


def _numpy(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=np.float64)


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:       # no tensorboard package: jsonl only
                pass

    def _write(self, record) -> None:
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int):
        value = float(_numpy(value))
        self._write({'t': time.time(), 'tag': tag, 'value': value,
                     'step': int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values: Sequence, step: int):
        arr = _numpy(values).reshape(-1)
        self._write({'t': time.time(), 'tag': tag, 'step': int(step),
                     'hist': {'mean': float(arr.mean()),
                              'std': float(arr.std()),
                              'min': float(arr.min()),
                              'max': float(arr.max()), 'n': int(arr.size)}})
        if self._tb is not None:
            self._tb.add_histogram(tag, arr, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
