"""The closed loop and its arithmetic.

Each unit of work (a training step, a grid frame) starts when the last one has returned its
result to the host.  Its time is a pair of CUDA events: one recorded as it is dispatched, on an
idle stream, one after it returns, so that the pair spans dispatch to completion on the device's
clock.  The window's time is the host's clock from its start to a ``torch.cuda.synchronize()``
after the last unit, at least the requested seconds; a rate is all the window's work over it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Tuple

STEP_SPAN = "bench.step"


@dataclasses.dataclass
class Window:
    seconds: float  # host clock, dispatch of the first unit to the synchronize after the last
    units: float  # work completed (points, frames)
    attempted: int
    failed: int
    times_ms: List[float]  # every unit's time, in order


class _HostMark:
    """A stand-in for a CUDA event where the run has no card (the CPU tests of the harness)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def closed_loop(step: Callable[[], Tuple[float, bool]], seconds: float, cuda: bool = True) -> Window:
    """Run ``step`` (-> (work, finite)) until ``seconds`` have passed."""
    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mark = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else _HostMark
    pairs, units, failed = [], 0.0, 0
    sync()
    t0 = time.perf_counter()
    while True:
        start, end = mark(), mark()
        with torch.profiler.record_function(STEP_SPAN):
            start.record()
            work, ok = step()
            end.record()
        pairs.append((start, end))
        if ok:
            units += work
        else:
            failed += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    return Window(seconds=elapsed, units=units, attempted=len(pairs), failed=failed,
                  times_ms=[a.elapsed_time(b) for a, b in pairs])


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that 95% of all values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def process_start_epoch() -> float:
    """When this process started, by the kernel's record, or now where that cannot be read."""
    try:
        import os

        with open("/proc/self/stat") as fp:
            fields = fp.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime: field 22 of the whole line, ticks after boot
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()
