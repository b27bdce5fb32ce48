"""A run with the timed path broken underneath comes out not correct.

Each fault of ``lib/faults.py`` that a cell can have is planted in the program, and the rest of a
run (set-up, a short window, the comparison against the cell's own limits) is driven at a tiny
width on the CPU, with the harness's look for a card left out; the unbroken run comes out correct."""

import time

import pytest
import torch

from benchmark.lib import faults, harness
from benchmark.tests.conftest import tiny_cell

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _run(cell, seed=21):
    result, compared, _ = harness.run_cell(cell, seed, 0.2, False, CPU, time.time())
    return result, compared


def _f32(cell):
    cell.precision = dict(cell.precision, dtype="float32")
    return cell


def test_unbroken_training_run_is_correct():
    result, compared = _run(tiny_cell("f32.train_pde"))
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_points_per_s", "train_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", ["f32.train_pde", "bf16.train_pde", "bf16.train_pde_dense"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_training_run_is_not_correct(fault, workload):
    with faults.planted(fault):
        result, compared = _run(tiny_cell(workload))
    assert not result["correct"], compared
    if fault == "half_batch":
        assert compared["batch_gap"]["value"] > 0.5 and compared["field1_gap"]["value"] > 0.5, compared


def test_unbroken_frames_are_correct():
    result, compared = _run(_f32(tiny_cell("bf16.infer_grid")))
    assert result["correct"], compared
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}


def test_an_altered_answer_is_not_correct():
    with faults.planted("altered"):
        result, compared = _run(_f32(tiny_cell("bf16.infer_grid")))
    assert not result["correct"], compared
