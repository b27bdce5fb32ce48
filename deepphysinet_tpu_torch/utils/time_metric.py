"""Wall-clock throughput counter: the port's copy of ``deepphysinet_tpu/utils/time_metric.py``
(API-compatible with the reference's metric/time_metric.py:8-30)."""

from __future__ import annotations

import time


class TimeMetric:
    def __init__(self):
        self.start_time = time.monotonic()

    def start(self):
        self.start_time = time.monotonic()

    def reset(self):
        self.start_time = time.monotonic()

    def get_time_ms(self) -> float:
        return (time.monotonic() - self.start_time) * 1000.0

    def get_time(self) -> float:
        return time.monotonic() - self.start_time

    def get_fps(self, total_frames: int) -> float:
        return total_frames / (self.get_time() + 1e-6)
