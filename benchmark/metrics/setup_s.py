"""Seconds from the process's start to the first timed unit: imports, the kernels' build or load,
weights and inputs from the seed, the cell's warm-up."""


def read(run):
    return run.setup_s
