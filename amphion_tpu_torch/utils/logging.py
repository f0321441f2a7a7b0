"""Logging helpers (port of `amphion_tpu/utils/logging.py`): a console
logger, a rolling average of step times, and a parameter count per
top-level module."""

from __future__ import annotations

import logging
import sys
from collections import deque

from torch import nn

_LOGGERS: dict[str, logging.Logger] = {}


def get_logger(name: str = "amphion_tpu_torch") -> logging.Logger:
    """An INFO logger writing to stderr, created once per name."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s | %(message)s", "%H:%M:%S"))
    logger.addHandler(sh)
    _LOGGERS[name] = logger
    return logger


class ValueWindow:
    """Rolling window average of scalar values (e.g. step durations)."""

    def __init__(self, window_size: int = 100):
        self._values: deque[float] = deque(maxlen=window_size)

    def append(self, x: float) -> None:
        self._values.append(float(x))

    @property
    def sum(self) -> float:
        return float(sum(self._values))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)


def model_summary(modules: dict[str, nn.Module], logger=None) -> int:
    """Log the parameter count of each named module and the total; returns
    the total."""
    log = (logger or get_logger()).info
    total = 0
    for name, module in modules.items():
        n = sum(p.numel() for p in module.parameters())
        total += n
        log(f"  {name}: {n / 1e6:.2f}M params")
    log(f"  total: {total / 1e6:.2f}M params")
    return total
