"""Training points completed per second where the host paces the step: the reading of
``train_points_per_s`` (every completed step's points over the window's time, host clock), reported
as a per-layer metric of host dispatch.  It follows the host's speed from run to run, too widely
there to carry a bound."""

from benchmark.lib import spec

read = spec.reader("train_points_per_s").read
