"""Model FLOPs of the training steps completed in the untraced stretch (``lib/yardstick.py``:
the model's layer shapes, tangents and backward), over its time, over the precision's peak, %."""


def read(run):
    if run.work["unit"] != "points":
        return None
    steps = run.window.units / run.work["per_step"]
    return 100.0 * steps * run.work["model_flops"] / run.window.seconds / run.peak_flops
