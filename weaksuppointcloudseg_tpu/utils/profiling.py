"""Tracing / profiling / observability hooks.

The reference has none of this (a hand timer is commented out at
ShapeNet_DGCNN_trainer.py:565-579; SURVEY.md §5). Provided here:

- ``trace``: context manager around ``jax.profiler`` for on-demand device
  traces (view with TensorBoard / xprof).
- ``StepTimer``: wall-clock + points/sec counters for train loops, with an
  exponential moving average. Dispatch is asynchronous: callers must wait
  for the device (``block_until_ready`` or a scalar fetch such as
  ``float(metrics['total'])``) before ``timer.stop()``.
- ``MetricsLogger``: structured JSONL metrics sink next to the reference's
  human-readable Summary.txt.
- ``nan_debug``: context manager enabling jax_debug_nans (the stand-in for
  a sanitizer pass, SURVEY.md §5 race-detection row).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace for the enclosed block."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def nan_debug(enable: bool = True) -> Iterator[None]:
    """Enable NaN checking for the enclosed block (debug runs only: it
    disables some fusions and forces extra device syncs)."""
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


class StepTimer:
    """Per-step wall-clock + throughput with EMA smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_step_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, points: int = 0) -> float:
        """Returns the step time in seconds; updates the EMA."""
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.avg_step_s = (
            dt if self.avg_step_s is None
            else self.ema * self.avg_step_s + (1 - self.ema) * dt
        )
        self._last_points = points
        return dt

    @property
    def points_per_sec(self) -> float:
        if not self.avg_step_s:
            return 0.0
        return self._last_points / self.avg_step_s


class MetricsLogger:
    """Append-mode JSONL metrics (one object per step/epoch event)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            open(path, "w").close()

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"event": event, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in fields.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
