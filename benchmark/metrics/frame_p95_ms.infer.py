"""The 95th percentile (nearest rank) of every frame of the untraced stretch, each timed by a pair
of CUDA events from its dispatch on an idle stream to its fields on the host."""

from benchmark.lib.timing import p95


def read(run):
    if run.work["unit"] != "frames" or not run.window.times_ms:
        return None
    return p95(run.window.times_ms)
