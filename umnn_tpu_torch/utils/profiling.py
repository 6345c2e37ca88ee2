"""Profiling helpers: a torch.profiler trace, and wall timing that waits
for the card.

PyTorch counterpart of `umnn_tpu/utils/profiling.py`. ``trace`` records
the CPU and, where there is a card, its CUDA kernels, and writes a Chrome
trace (open it in Perfetto or ``chrome://tracing``). CUDA launches return
before the card has run them, so the timers synchronize the device of the
result before reading the clock; on CPU tensors there is nothing to wait
for. Times are in seconds, as the JAX package's.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable

import torch

__all__ = ["device_time", "timed_steps", "trace"]


@contextlib.contextmanager
def trace(logdir: str | Path = "build/trace"):
    """Profile the block and write ``<logdir>/trace.json``:

        with trace("build/trace") as path:
            step(batch)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(logdir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _first_tensor(out: Any) -> torch.Tensor | None:
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _drain(out: Any) -> None:
    """Wait until the device of ``out``'s first tensor has finished."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def device_time(fn: Callable, *args, iters: int = 20) -> float:
    """Seconds per call of ``fn(*args)``: ``iters`` calls enqueued, waited
    for once, less one call's wait (the floor of a dispatch and its
    synchronization), over ``iters - 1``."""
    _drain(fn(*args))
    t0 = time.perf_counter()
    _drain(fn(*args))
    floor = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _drain(out)
    return max((time.perf_counter() - t0 - floor) / max(iters - 1, 1), 0.0)


def timed_steps(step_fn: Callable, n: int = 10, **kwargs) -> dict:
    """``step_fn(**kwargs)`` ``n`` times, each waited for: the mean, least,
    most and total seconds."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _drain(step_fn(**kwargs))
        ts.append(time.perf_counter() - t0)
    return {"mean_s": sum(ts) / len(ts), "min_s": min(ts), "max_s": max(ts), "total_s": sum(ts)}
