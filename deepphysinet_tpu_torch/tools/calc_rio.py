"""Surface air density (rio) GeoTIFFs from PSFC, t2 and q2, the port's counterpart of
``tools/calc_rio.py``:

    python -m deepphysinet_tpu_torch.tools.calc_rio --data_path TREE_DIR [--num_threads N]

rho = P / ((1 + 0.608 q) R_d T), the moist gas law, written as ``*_rio.tiff`` next to each
``*_PSFC.tiff`` of ``data_path`` and its subfolders whose ``_t2`` and ``_q2`` rasters exist.
Existing outputs are kept.  ``main(argv)`` returns the GeoTIFFs it wrote.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from deepphysinet_tpu_torch.data.geotiff import read_full_image, save_full_image
from deepphysinet_tpu_torch.tools import chunks, run_workers
from deepphysinet_tpu_torch.utils import path_utils

R_D = 287.0


def process(data_files, thread_id=0) -> List[str]:
    """rio beside each ``*_PSFC.tiff`` of ``data_files``; returns the GeoTIFFs written."""
    written = []
    for data_file in data_files:
        file_name = path_utils.get_filename(data_file, is_suffix=False).replace("_PSFC", "")
        p_path = path_utils.get_parent_folder(data_file, with_root=True)
        rio_file = os.path.join(p_path, f"{file_name}_rio.tiff")
        if os.path.exists(rio_file):
            continue
        t_file = os.path.join(p_path, f"{file_name}_t2.tiff")
        q_file = os.path.join(p_path, f"{file_name}_q2.tiff")
        if not (os.path.exists(t_file) and os.path.exists(q_file)):
            continue
        P = read_full_image(data_file, as_rgb=False, normalize=False)[0]
        T = read_full_image(t_file, as_rgb=False, normalize=False)[0]
        q = read_full_image(q_file, as_rgb=False, normalize=False)[0]
        rio = P / ((1 + 0.608 * q) * R_D) / T
        save_full_image(rio_file, rio.astype(np.float32), compression="deflate", tiled=True)
        written.append(rio_file)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the tool; returns the GeoTIFFs written."""
    parser = argparse.ArgumentParser("rio from PSFC, t2 and q2")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--num_threads", type=int, default=0)
    args = parser.parse_args(argv)
    files = glob.glob(os.path.join(args.data_path, "*/*_PSFC.tiff"))
    files += glob.glob(os.path.join(args.data_path, "*_PSFC.tiff"))
    jobs = [(part, i) for i, part in enumerate(chunks(files, args.num_threads))]
    return [f for part in run_workers(process, jobs, args.num_threads) for f in part]


if __name__ == "__main__":
    main(sys.argv[1:])
