"""Split GRIB archives into one netCDF file per level group, the port's counterpart of
``tools/cvt_grib_to_nc.py``:

    python -m deepphysinet_tpu_torch.tools.cvt_grib_to_nc --data_path GRIB_DIR --result_path NC_DIR
        [--pressure] [--num_threads N]

Each ``*.grib`` / ``*.grib2`` file ``{name}`` becomes ``{name}_surface.nc`` (``sp``),
``{name}_2m.nc`` (``t2m``, ``d2m``) and ``{name}_10m.nc`` (``u10``, ``v10``), or with
``--pressure`` ``{name}_{level}hpa.nc`` for each level of ``PRESSURE_LEVELS`` (``u``, ``v``, ``t``,
``gh``, ``q``).  Existing outputs are kept.  xarray with cfgrib reads the GRIB where both import;
without them, GRIB edition 2 goes through ``data/grib2.py`` (grid template 3.0, simple packing) and
is written as classic CDF-1 netCDF.  ``main(argv)`` returns the netCDF files it wrote.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional, Sequence

from deepphysinet_tpu_torch.tools import chunks, run_workers
from deepphysinet_tpu_torch.utils import path_utils

PRESSURE_LEVELS = (1000, 925, 850, 700, 500)
SURFACE_GROUPS = (
    ("surface", {"typeOfLevel": "surface", "level": 0}),
    ("2m", {"typeOfLevel": "heightAboveGround", "level": 2}),
    ("10m", {"typeOfLevel": "heightAboveGround", "level": 10}),
)


def _cfgrib_available() -> bool:
    try:
        import cfgrib  # noqa: F401  (raises RuntimeError where the ecCodes library is missing)
        import xarray  # noqa: F401
    except (ImportError, RuntimeError):
        return False
    return True


def _default_load(data_file: str, filter_by_keys: dict):
    """GRIB subset -> dataset with ``.to_netcdf(path)``: xarray + cfgrib (either GRIB edition)
    where both import, else the built-in edition-2 codec."""
    if _cfgrib_available():
        import xarray as xr

        return xr.load_dataset(data_file, engine="cfgrib", backend_kwargs={"filter_by_keys": filter_by_keys})
    with open(data_file, "rb") as f:
        edition = f.read(8)[7:8]
    if edition != b"\x02":
        raise SystemExit(f"{data_file}: GRIB edition {edition!r} needs xarray + cfgrib; the built-in codec "
                         "reads edition 2")
    from deepphysinet_tpu_torch.data.grib2 import load_dataset

    return load_dataset(data_file, filter_by_keys)


def process_pressure(data_files, result_folder, thread_id=0, load_fn=None) -> List[str]:
    """Per-pressure-level split of ``data_files`` into ``result_folder``; ``load_fn(path,
    filter_by_keys) -> dataset`` is injectable.  Removes cfgrib's ``.idx`` files beside each input.
    Returns the files written."""
    load_fn = load_fn or _default_load
    written = []
    for data_file in data_files:
        name = path_utils.get_filename(data_file, is_suffix=False)
        for level in PRESSURE_LEVELS:
            out = os.path.join(result_folder, f"{name}_{level}hpa.nc")
            if os.path.exists(out):
                continue
            load_fn(data_file, {"typeOfLevel": "isobaricInhPa", "level": level}).to_netcdf(out)
            written.append(out)
        for idx in glob.glob(os.path.join(os.path.dirname(data_file), f"{name}*.idx")):
            os.remove(idx)
    return written


def process_surface(data_files, result_folder, thread_id=0, load_fn=None) -> List[str]:
    """Surface / 2 m / 10 m split of ``data_files`` into ``result_folder`` (``load_fn`` as in
    ``process_pressure``).  A file that fails to split raises: the JAX tool printed its name and
    went on.  Returns the files written."""
    load_fn = load_fn or _default_load
    written = []
    for data_file in data_files:
        name = path_utils.get_filename(data_file, is_suffix=False)
        for suffix, filter_by_keys in SURFACE_GROUPS:
            out = os.path.join(result_folder, f"{name}_{suffix}.nc")
            if os.path.exists(out):
                continue
            load_fn(data_file, filter_by_keys).to_netcdf(out)
            written.append(out)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the tool; returns the netCDF files written."""
    parser = argparse.ArgumentParser("GRIB -> per-level netCDF")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--result_path", type=str, required=True)
    parser.add_argument("--pressure", action="store_true", default=False)
    parser.add_argument("--num_threads", type=int, default=0)
    args = parser.parse_args(argv)
    os.makedirs(args.result_path, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.data_path, "*.grib"))
                   + glob.glob(os.path.join(args.data_path, "*.grib2")))
    fn = process_pressure if args.pressure else process_surface
    jobs = [(part, args.result_path, i) for i, part in enumerate(chunks(files, args.num_threads))]
    return [f for part in run_workers(fn, jobs, args.num_threads) for f in part]


if __name__ == "__main__":
    main(sys.argv[1:])
