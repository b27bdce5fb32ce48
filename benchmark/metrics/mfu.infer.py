"""Model FLOPs of the grid frames completed in the untraced stretch (``lib/yardstick.py``:
an encode and the decode at every point), over its time, over the precision's peak, %."""


def read(run):
    if run.work["unit"] != "frames":
        return None
    steps = run.window.units / run.work["per_step"]
    return 100.0 * steps * run.work["model_flops"] / run.window.seconds / run.peak_flops
