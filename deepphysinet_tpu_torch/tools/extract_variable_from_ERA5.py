"""Extract hourly ERA5 label GeoTIFFs from ERA5 netCDF files, the port's counterpart of
``tools/extract_variable_from_ERA5.py``:

    python -m deepphysinet_tpu_torch.tools.extract_variable_from_ERA5 --data_path ERA5_DIR
        --result_path TREE/labels [--start_time %Y-%m-%d-%H:%M:%S] [--end_time ...] [--num_threads N]

Each ``*.nc`` file holds the single-level variables ``sp``, ``t2m``, ``u10``, ``v10`` and ``d2m``
on an hourly ``time`` axis (hours since 1900-01-01), classic netCDF or netCDF-4, packed int16 with
``scale_factor`` / ``add_offset`` as the CDS delivers them.  Each hour within the time range becomes
``ERA5_%Y-%m-%d-%H-%M-%S_<var>.tiff`` (PSFC, t2, u10, v10, q2; q2 from the dew point and PSFC,
``physics/thermo.py``), rows flipped to ascend from the south.  Existing outputs are kept.
``main(argv)`` returns the GeoTIFFs it wrote.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from deepphysinet_tpu_torch.data.geotiff import read_full_image, save_full_image
from deepphysinet_tpu_torch.physics.thermo import specific_humidity_from_dewpoint
from deepphysinet_tpu_torch.tools import chunks, open_netcdf, run_workers

# ERA5 single-level names -> the framework's; PSFC must precede q2
VAR_NAMES = ["sp", "t2m", "u10", "v10", "d2m"]
PROJ_NAMES = ["PSFC", "t2", "u10", "v10", "q2"]


def process(data_files, result_path, var_name_list, proj_name_list, start_time, end_time, data_shape,
            thread_id=0, open_fn=None) -> List[str]:
    """Hourly label extraction of ``data_files``; ``open_fn(path) -> variables`` is injectable.
    Returns the GeoTIFFs written."""
    open_fn = open_fn or open_netcdf
    ref_time = datetime.datetime(1900, 1, 1)
    os.makedirs(result_path, exist_ok=True)
    written = []
    for data_file in data_files:
        var_dict = open_fn(data_file)
        hours = var_dict["time"]
        for var_name, proj_name in zip(var_name_list, proj_name_list):
            for i in range(len(hours)):
                ts = ref_time + datetime.timedelta(hours=float(hours[i].data))
                if not (start_time <= ts <= end_time):
                    continue
                out = os.path.join(result_path, f"ERA5_{ts.strftime('%Y-%m-%d-%H-%M-%S')}_{proj_name}.tiff")
                if os.path.exists(out):
                    continue
                data = var_dict[var_name][i]
                data = np.asarray(data[:, ::-1] if data.ndim == 3 else data[::-1])
                if data_shape is not None and data.shape[-2:] != tuple(data_shape[-2:]):
                    raise ValueError(f"{data_file}: {var_name} is {data.shape[-2:]}, not {tuple(data_shape[-2:])}")
                if proj_name == "q2":
                    pres_file = os.path.join(result_path, f"ERA5_{ts.strftime('%Y-%m-%d-%H-%M-%S')}_PSFC.tiff")
                    pres = read_full_image(pres_file, as_rgb=False, normalize=False)[0]
                    data = specific_humidity_from_dewpoint(pres, data)
                save_full_image(out, data.astype(np.float32), compression="deflate", tiled=True)
                written.append(out)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the tool; returns the GeoTIFFs written."""
    parser = argparse.ArgumentParser("ERA5 netCDF -> hourly label GeoTIFFs")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--result_path", type=str, required=True)
    parser.add_argument("--num_threads", type=int, default=0)
    parser.add_argument("--start_time", type=str, default="2007-01-01-00:00:00")
    parser.add_argument("--end_time", type=str, default="2021-12-31-23:00:00")
    args = parser.parse_args(argv)
    start = datetime.datetime.strptime(args.start_time, "%Y-%m-%d-%H:%M:%S")
    end = datetime.datetime.strptime(args.end_time, "%Y-%m-%d-%H:%M:%S")
    files = sorted(glob.glob(os.path.join(args.data_path, "*.nc")))
    jobs = [(part, args.result_path, VAR_NAMES, PROJ_NAMES, start, end, None, i)
            for i, part in enumerate(chunks(files, args.num_threads))]
    return [f for part in run_workers(process, jobs, args.num_threads) for f in part]


if __name__ == "__main__":
    main(sys.argv[1:])
