"""The share of an untraced frame's time in which no kernel, copy or fill runs on the device, %.

The device's busy time a unit comes from the device stretch of the trace (the union of its
kernels, copies and fills over its units); the unit's time from the untraced window (its time over
its units), since tracing slows the host's dispatch and so stretches the traced window's gaps."""


def read(run):
    if run.trace is None or run.work["unit"] != "frames" or not run.trace["steps"] or not run.window.attempted:
        return None
    busy = run.trace["busy_s"] / run.trace["steps"]
    return 100.0 * (1.0 - busy / (run.window.seconds / run.window.attempted))
