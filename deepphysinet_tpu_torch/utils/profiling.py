"""Tracing / profiling hooks.

Counterpart of ``deepphysinet_tpu/utils/profiling.py``.  The reference's only
observability is a wall-clock fps counter (metric/time_metric.py:8-30); here:

* ``trace`` context manager around a section -> a ``torch.profiler`` trace of the
  host and, where there is one, the CUDA device, written as a Chrome trace
  (viewable in Perfetto or chrome://tracing) to ``trace_dir``;
* ``ThroughputMeter`` -- collocation-point residual evals/sec and optimizer
  steps/sec, the framework's headline counters;
* ``step_annotation`` -- a named step marker: a ``record_function`` range in the
  trace and, on CUDA, an NVTX range, so traces segment per optimizer step.

All hooks are no-ops when profiling is off; no entry point calls them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block (if a dir is given) into
    ``trace_dir/trace_<pid>_<ns>.json``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def step_annotation(name: str, step: int):
    """Named step marker inside a trace (``name#step``); costs a range push and pop outside one."""
    label = f"{name}#{step}"
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class ThroughputMeter:
    """Sliding-window throughput: points/sec and steps/sec."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.monotonic()
        self._points = 0
        self._steps = 0

    def update(self, n_points: int, n_steps: int = 1) -> None:
        self._points += n_points
        self._steps += n_steps

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._t0 + 1e-9

    def points_per_sec(self) -> float:
        return self._points / self.elapsed

    def steps_per_sec(self) -> float:
        return self._steps / self.elapsed

    def summary(self) -> dict:
        return {
            "points_per_sec": self.points_per_sec(),
            "steps_per_sec": self.steps_per_sec(),
            "elapsed_s": self.elapsed,
        }
