"""Shared pieces of the benchmark's own tests: a cell cut to a tiny width for the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec  # noqa: E402


def tiny_cell(workload: str, **traffic):
    """``workload``'s cell with the model cut to a few units a layer and a 13 x 21 grid (enc_in
    24 = 4 x 6 coarse points), a few points and frames: for the CPU, where the program runs its
    plain versions.  The cell's own limits stay."""
    cell = spec.cell(workload)
    c = copy.deepcopy(cell.config)
    c["meta_cfg"].update(enc_in=24, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32, learnable_token_num=8)
    c["net_cfg"].update(hidden_channels=32, token_num=12, learnable_token_num=16)
    c["train_cfg"]["img_size"] = [13, 21]
    tr = dict(cell.traffic)
    tr.update(n_margin=96, n_inter=32, windows=2, hours=3, trace_steps=2)
    tr.update(traffic)
    cell.config, cell.traffic = c, tr
    return cell


@pytest.fixture
def cuda_device():
    """The first CUDA card; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
