"""Console and file logger, and a JSONL stream of scalar metrics.

PyTorch-side counterpart of `umnn_tpu/utils/logging.py:20-84` (which takes
no JAX): ``get_logger`` logs to the console and to a file;
``MetricsWriter`` appends one ``{"step", "tag", "value", "ts"}`` record per
scalar; ``AverageMeter`` keeps a running mean. Not ported:
``get_logger``'s options to switch either handler off or to copy the
calling script's source into the log, which no driver of the port uses.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

__all__ = ["AverageMeter", "MetricsWriter", "get_logger"]


def get_logger(name: str, logpath: str | Path) -> logging.Logger:
    """Logger to the console and to ``logpath`` (opened for appending)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    Path(logpath).parent.mkdir(parents=True, exist_ok=True)
    logger.addHandler(logging.FileHandler(logpath, mode="a"))
    logger.addHandler(logging.StreamHandler(sys.stdout))
    return logger


class MetricsWriter:
    """Append-only JSONL stream of scalars, flushed after each record."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        record = {"step": step, "tag": tag, "value": float(value), "ts": time.time()}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class AverageMeter:
    """Running mean of a stream of scalars, each weighted by ``n``."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
