"""Training points completed per second: the labelled and collocation points of every step the
window completed, over the window's time (host clock, ending in a synchronize)."""


def read(run):
    if run.work["unit"] != "points":
        return None
    return run.window.units / run.window.seconds
