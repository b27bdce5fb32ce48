"""The v4s backward kernel's least time over its device time in the traced stretch, %.

The least time of each launch is the larger of its FLOPs over the precision's peak and its bytes
over the memory bandwidth (``lib/yardstick.py``), for the points the step gives each launch."""

from benchmark.lib.roofline import share

FAMILY = "decode_bwd_v4s"


def read(run):
    return share(run, FAMILY)
