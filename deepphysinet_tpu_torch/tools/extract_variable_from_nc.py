"""Extract per-variable GeoTIFFs from converted GFS / TIGGE netCDF files, the port's counterpart
of ``tools/extract_variable_from_nc.py``:

    python -m deepphysinet_tpu_torch.tools.extract_variable_from_nc --data_path NC_DIR
        --result_path TREE/input/NCEP [--pressure] [--num_threads N]

Writes ``<result>/<year>/GFS_%Y-%m-%d-%H-%M-%S_f%03d_<var>.tiff`` for each init time and lead of
each file (deflate, tiled), rows flipped to ascend from the south.  The surface mode reads each
``*_surface.nc`` together with the ``_2m`` and ``_10m`` files that ``cvt_grib_to_nc`` split off the
same GRIB file, and writes PSFC, t2, u10, v10 and q2 (from the 2 m dew point and PSFC,
``physics/thermo.py``).  The pressure mode reads each ``*_1000hpa.nc`` with its other levels and
writes 5-level stacks of UU, VV, TT, GHT and QQ.  Existing outputs are kept.  ``main(argv)``
returns the GeoTIFFs it wrote.
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
from deepphysinet_tpu_torch.utils import path_utils

PRESSURE_LEVELS = (1000, 925, 850, 700, 500)
SURFACE_GROUPS = ("surface", "2m", "10m")  # cvt_grib_to_nc's files of one GRIB file
SURFACE_VARS = (["sp", "t2m", "u10", "v10", "d2m"], ["PSFC", "t2", "u10", "v10", "q2"])  # PSFC before q2


def extract_data(var_dict, var_name, index):
    data = var_dict[var_name][index]
    if len(data.shape) == 3:
        data = data[:, ::-1]
    elif len(data.shape) == 2:
        data = data[::-1]
    else:
        raise NotImplementedError
    return np.asarray(data)


def surface_variables(data_file: str, open_fn):
    """The variables of ``data_file``; for a ``{name}_surface.nc``, together with those of its
    ``{name}_2m.nc`` and ``{name}_10m.nc`` where they exist, whose ``time`` and ``step`` must equal
    the surface file's.  (The JAX tool read the surface file alone and found no ``t2m`` there.)"""
    stem, ext = os.path.splitext(data_file)
    if not stem.endswith("_surface"):
        return open_fn(data_file)
    merged = dict(open_fn(data_file))
    for group in SURFACE_GROUPS[1:]:
        sibling = f"{stem[:-len('_surface')]}_{group}{ext}"
        if not os.path.exists(sibling):
            continue
        variables = open_fn(sibling)
        for axis in ("time", "step"):
            if not np.array_equal(np.asarray(variables[axis][:]), np.asarray(merged[axis][:])):
                raise ValueError(f"{sibling}: its {axis} differs from {data_file}'s")
        merged.update({k: v for k, v in variables.items() if k not in merged})
    return merged


def _gfs_name(out_dir: str, ts: datetime.datetime, step: int, proj_name: str) -> str:
    return os.path.join(out_dir, f"GFS_{ts.strftime('%Y-%m-%d-%H-%M-%S')}_f{step:03d}_{proj_name}.tiff")


def process_surface(data_files, result_folder, var_name_list, proj_name_list, thread_id=0,
                    open_fn=None) -> List[str]:
    """Surface-variable extraction of ``data_files`` (``surface_variables``); ``open_fn(path) ->
    variables`` is injectable.  Returns the GeoTIFFs written."""
    open_fn = open_fn or open_netcdf
    ref_time = datetime.datetime(1970, 1, 1)
    written = []
    for var_name, proj_name in zip(var_name_list, proj_name_list):
        for data_file in data_files:
            var_dict = surface_variables(data_file, open_fn)
            seconds = var_dict["time"]
            step_list = var_dict["step"]
            for i in range(len(seconds)):
                ts = ref_time + datetime.timedelta(seconds=float(seconds[i].data))
                for step_i in range(len(step_list)):
                    step = int(step_list[step_i].data)
                    out_dir = os.path.join(result_folder, f"{ts.year:04d}")
                    os.makedirs(out_dir, exist_ok=True)
                    out = _gfs_name(out_dir, ts, step, proj_name)
                    if os.path.exists(out):
                        continue
                    data = extract_data(var_dict, var_name, (i, step_i))
                    if proj_name == "q2":
                        pres = read_full_image(_gfs_name(out_dir, ts, step, "PSFC"), as_rgb=False, normalize=False)[0]
                        data = specific_humidity_from_dewpoint(pres, data)
                    save_full_image(out, data.astype(np.float32), compression="deflate", tiled=True)
                    written.append(out)
    return written


def process_pressure(data_files, data_path, result_folder, thread_id=0, open_fn=None) -> List[str]:
    """Pressure-level stack extraction: each ``{name}_1000hpa.nc`` of ``data_files`` with the
    ``{name}_{level}hpa.nc`` files of ``data_path`` (``open_fn`` as in ``process_surface``).
    Returns the GeoTIFFs written."""
    open_fn = open_fn or open_netcdf
    var_name_list = ["u", "v", "t", "gh", "q"]
    proj_name_list = ["UU", "VV", "TT", "GHT", "QQ"]
    ref_time = datetime.datetime(1970, 1, 1)
    written = []
    for data_file in data_files:
        base = path_utils.get_filename(data_file, is_suffix=False).replace("_1000hpa", "")
        level_vars = {lv: open_fn(os.path.join(data_path, f"{base}_{lv}hpa.nc")) for lv in PRESSURE_LEVELS}
        ref_vars = level_vars[1000]
        seconds = ref_vars["time"]
        step_list = ref_vars["step"]
        for var_name, proj_name in zip(var_name_list, proj_name_list):
            for i in range(len(seconds)):
                ts = ref_time + datetime.timedelta(seconds=float(seconds[i].data))
                for step_i in range(len(step_list)):
                    step = int(step_list[step_i].data)
                    out_dir = os.path.join(result_folder, f"{ts.year:04d}")
                    os.makedirs(out_dir, exist_ok=True)
                    out = _gfs_name(out_dir, ts, step, proj_name)
                    if os.path.exists(out):
                        continue
                    stack = np.stack([extract_data(level_vars[lv], var_name, (i, step_i)) for lv in PRESSURE_LEVELS],
                                     axis=-3)
                    save_full_image(out, stack.astype(np.float32), data_format="GDAL_FORMAT", compression="deflate",
                                    tiled=True)
                    written.append(out)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the tool; returns the GeoTIFFs written."""
    parser = argparse.ArgumentParser("GFS / TIGGE netCDF -> GeoTIFF")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--result_path", type=str, required=True)
    parser.add_argument("--pressure", action="store_true", default=False)
    parser.add_argument("--num_threads", type=int, default=0)
    args = parser.parse_args(argv)
    os.makedirs(args.result_path, exist_ok=True)
    if args.pressure:
        files = sorted(glob.glob(os.path.join(args.data_path, "*_1000hpa.nc")))
        jobs = [(part, args.data_path, args.result_path, i) for i, part in enumerate(chunks(files, args.num_threads))]
        fn = process_pressure
    else:
        files = sorted(glob.glob(os.path.join(args.data_path, "*_surface.nc")))
        jobs = [(part, args.result_path, *SURFACE_VARS, i) for i, part in enumerate(chunks(files, args.num_threads))]
        fn = process_surface
    return [f for part in run_workers(fn, jobs, args.num_threads) for f in part]


if __name__ == "__main__":
    main(sys.argv[1:])
