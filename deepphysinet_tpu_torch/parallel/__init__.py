"""Data-parallel training over several GPUs (counterpart of ``deepphysinet_tpu/parallel/``):
``multihost`` (the process group), ``mesh`` (each rank's place on the (data, points) mesh),
``sharding`` (the steps with their gradients and metrics averaged over the ranks) and ``dryrun``
(a spawned rehearsal of the sharded steps)."""
