"""A kernel family's share of its roofline in the traced stretch."""

from __future__ import annotations

from typing import Optional

from benchmark.lib.yardstick import least_kernel_seconds


def share(run, family: str) -> Optional[float]:
    """100 x (the least time of the family's launches over the traced units) / (their device time);
    None where the trace holds no launch of the family or the cell gives it no work."""
    if run.trace is None:
        return None
    seen = run.trace["families"].get(family)
    per_unit = run.work["kernels"].get(family)
    if not seen or not seen["launches"] or seen["seconds"] <= 0 or not per_unit:
        return None
    least = run.trace["steps"] * least_kernel_seconds(run.config, family, per_unit, run.dtype)
    return 100.0 * least / seen["seconds"]
