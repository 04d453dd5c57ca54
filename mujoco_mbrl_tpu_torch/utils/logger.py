"""Console + file logger singleton (port of mujoco_mbrl_tpu/utils/logger.py,
without the ANSI colours)."""

from __future__ import annotations

import logging
import sys
from typing import Optional


class LoggerClass:
    _instance: Optional['LoggerClass'] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._init()
        return cls._instance

    def _init(self):
        self._logger = logging.getLogger('mujoco_mbrl_tpu_torch')
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(message)s', '%H:%M:%S'))
        self._logger.addHandler(handler)
        self._file_handler = None

    def setup(self, log_path: Optional[str] = None, level: str = 'info'):
        self._logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        if log_path:
            if self._file_handler:
                self._logger.removeHandler(self._file_handler)
                self._file_handler.close()
            self._file_handler = logging.FileHandler(log_path)
            self._file_handler.setFormatter(logging.Formatter(
                '%(asctime)s %(levelname)s %(message)s'))
            self._logger.addHandler(self._file_handler)

    def __getattr__(self, name):
        return getattr(self._logger, name)


logger = LoggerClass()
