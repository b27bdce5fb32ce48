"""The 95th percentile (nearest rank) of every training step of the window, each timed by a pair
of CUDA events from its dispatch on an idle stream to its completion."""

from benchmark.lib.timing import p95


def read(run):
    if run.work["unit"] != "points" or not run.window.times_ms:
        return None
    return p95(run.window.times_ms)
