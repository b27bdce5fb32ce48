"""The controls come out not correct on the card: each cell's reference computed in the precision
below its configuration's (fp8 for bfloat16, TF32 for float32) in the program's place, at the
cell's own sizes, on three seeds, held to the cell's limits.  Needs a card:
``python -m pytest benchmark/tests/test_bench_control.py -m cuda`` (a few minutes on an H100)."""

import pytest
import torch

from benchmark.lib import checks, spec

CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]
SEEDS = (2468, 1357913, 3141592653)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, cuda_device):
    cell = spec.cell(workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = spec.kind_module(cell.traffic)
    for seed in SEEDS:
        numbers = kind.control_numbers(cell, seed, cuda_device, cell.precision["control"])
        correct, compared = checks.judge(numbers, cell.limits)
        assert not correct, (seed, compared)
