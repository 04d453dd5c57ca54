"""Metrics writer: one JSON record per line in ``metrics.jsonl``.

The records are those of the JAX ``MetricsWriter``
(mujoco_mbrl_tpu/utils/metrics.py): scalars ``{t, tag, value, step}`` and
histograms ``{t, tag, step, hist: {mean, std, min, max, n}}``. No
TensorBoard events are written.
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
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')

    def _write(self, record) -> None:
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int):
        self._write({'t': time.time(), 'tag': tag,
                     'value': float(_numpy(value)), 'step': int(step)})

    def add_histogram(self, tag: str, values: Sequence, step: int):
        arr = _numpy(values).reshape(-1)
        self._write({'t': time.time(), 'tag': tag, 'step': int(step),
                     'hist': {'mean': float(arr.mean()),
                              'std': float(arr.std()),
                              'min': float(arr.min()),
                              'max': float(arr.max()), 'n': int(arr.size)}})

    def close(self):
        self._f.close()
