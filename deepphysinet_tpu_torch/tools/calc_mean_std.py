"""Per-variable normalization statistics over a GeoTIFF tree, the port's counterpart of
``tools/calc_mean_std.py``:

    python -m deepphysinet_tpu_torch.tools.calc_mean_std --data_path TREE_DIR --result_path STATS_DIR
        [--vars PSFC t2 ...] [--sample_stride 10] [--num_threads N]

For each variable, every ``--sample_stride``-th of its rasters (in a shuffle seeded 0) gives a
two-pass mean and standard deviation, one per band (per pressure level for the 5-level stacks),
written as ``<result_path>/<var>.txt``.  With ``--num_threads`` the variables are split among the
workers, each with the same ``--sample_stride``.  ``main(argv)`` returns ``{var: (mean, std)}``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from deepphysinet_tpu_torch.data.geotiff import read_full_image
from deepphysinet_tpu_torch.tools import chunks, run_workers

DEFAULT_VARS = ["PSFC", "GHT", "t2", "TT", "u10", "UU", "v10", "VV", "q2", "QQ", "rio"]


def process(data_path, var_names, result_path, thread_id=0, sample_stride=10) -> Dict[str, Tuple[list, list]]:
    """Statistics of ``var_names``; returns ``{var: (mean, std)}`` of those that have rasters."""
    os.makedirs(result_path, exist_ok=True)
    stats = {}
    for var in var_names:
        files = sorted(glob.glob(os.path.join(data_path, "*", f"*_{var}.tiff"))
                       + glob.glob(os.path.join(data_path, f"*_{var}.tiff")))
        rng = np.random.RandomState(0)
        rng.shuffle(files)
        files = files[::sample_stride] or files
        if not files:
            print(f"{var}: no files")
            continue
        # two passes: sums, then squared deviations, per channel
        total = None
        count = 0
        for f in files:
            img = read_full_image(f, as_rgb=False, normalize=False, data_format="NUMPY_FORMAT")
            s = img.reshape(-1, img.shape[-1]).sum(axis=0, dtype=np.float64)
            total = s if total is None else total + s
            count += img.shape[0] * img.shape[1]
        mean = total / count
        total_sq = None
        for f in files:
            img = read_full_image(f, as_rgb=False, normalize=False, data_format="NUMPY_FORMAT")
            s = ((img.reshape(-1, img.shape[-1]).astype(np.float64) - mean) ** 2).sum(axis=0)
            total_sq = s if total_sq is None else total_sq + s
        std = np.sqrt(total_sq / count)
        with open(os.path.join(result_path, f"{var}.txt"), "w") as fp:
            fp.write("mean:{0};\n std:{1};".format(mean.tolist(), std.tolist()))
        print(var, "mean", mean.tolist(), "std", std.tolist())
        stats[var] = (mean.tolist(), std.tolist())
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Tuple[list, list]]:
    """Run the tool; returns ``{var: (mean, std)}``."""
    parser = argparse.ArgumentParser("per-variable mean and std of a GeoTIFF tree")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--result_path", type=str, required=True)
    parser.add_argument("--num_threads", type=int, default=0)
    parser.add_argument("--vars", type=str, nargs="*", default=DEFAULT_VARS)
    parser.add_argument("--sample_stride", type=int, default=10, help="use every Nth file (reference default: 10)")
    args = parser.parse_args(argv)
    jobs = [(args.data_path, part, args.result_path, i, args.sample_stride)
            for i, part in enumerate(chunks(args.vars, args.num_threads))]
    return {k: v for part in run_workers(process, jobs, args.num_threads) for k, v in part.items()}


if __name__ == "__main__":
    main(sys.argv[1:])
