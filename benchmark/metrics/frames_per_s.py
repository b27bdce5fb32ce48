"""Grid frames completed per second: frames whose fields reached the host, over the window's time."""


def read(run):
    if run.work["unit"] != "frames":
        return None
    return run.window.units / run.window.seconds
