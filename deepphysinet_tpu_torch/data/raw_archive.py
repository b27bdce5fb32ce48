"""Write a GeoTIFF tree back out as the raw archives that users download, for the ETL tools to
read: one GFS GRIB2 file per init time and one ERA5 single-level NetCDF-3 file per day.

* ``GFS_%Y%m%d%H.grib2``: for each lead of the tree's index, surface ``sp``, ``2t`` and ``2d`` at
  2 m (the dew point from the tree's q2 and PSFC, ``physics/thermo.py``), ``10u`` and ``10v``, and
  ``u``, ``v``, ``t``, ``gh`` and ``q`` at each of ``PRESSURE_LEVELS``, on the input grid with rows
  from the north (``data/grib2.py``'s writer: templates 3.0 / 4.0 / 5.0, 16-bit simple packing).
* ``ERA5_%Y%m%d.nc``: the day's labelled hours of ``sp``, ``t2m``, ``u10``, ``v10`` and ``d2m``
  (time in hours since 1900-01-01, rows from the north), packed int16 with ``scale_factor`` /
  ``add_offset`` and ``_FillValue`` / ``missing_value`` -32767 as the CDS's classic downloads are
  (``data/netcdf_classic.py``'s writer).

The tree's rio rasters are not written: ``tools/calc_rio.py`` derives rio from P, T and q.
"""

from __future__ import annotations

import datetime
import glob
import os
import pickle
import re
from typing import Dict, List

import numpy as np

from deepphysinet_tpu_torch.data import grib2
from deepphysinet_tpu_torch.data.geotiff import read_full_image
from deepphysinet_tpu_torch.data.netcdf_classic import write_classic
from deepphysinet_tpu_torch.physics.thermo import dewpoint_from_specific_humidity

PRESSURE_LEVELS = (1000, 925, 850, 700, 500)
_DATE_FMT = "%Y-%m-%d-%H-%M-%S"
# tree variable -> (discipline, category, number, typeOfLevel, level) of its GRIB2 message
GRIB_SURFACE = {
    "PSFC": (0, 3, 0, "surface", 0.0),  # sp
    "t2": (0, 0, 0, "heightAboveGround", 2.0),  # 2t
    "q2": (0, 0, 6, "heightAboveGround", 2.0),  # 2d, from q2 and PSFC
    "u10": (0, 2, 2, "heightAboveGround", 10.0),  # 10u
    "v10": (0, 2, 3, "heightAboveGround", 10.0),  # 10v
}
GRIB_PRESSURE = {"UU": (0, 2, 2), "VV": (0, 2, 3), "TT": (0, 0, 0), "GHT": (0, 3, 5), "QQ": (0, 1, 0)}
# tree label -> ERA5 single-level name
ERA5_NAMES = {"PSFC": "sp", "t2": "t2m", "u10": "u10", "v10": "v10", "q2": "d2m"}
ERA5_FILL = -32767


def _raster(path: str) -> np.ndarray:
    return read_full_image(path, as_rgb=False, normalize=False, data_format="NUMPY_FORMAT")


def _axes(coord_file: str):
    with open(coord_file, "rb") as fp:
        lon, lat = pickle.load(fp)
    return np.asarray(lon)[0], np.asarray(lat)[:, 0]


def write_gfs_grib2(paths: Dict[str, str], out_dir: str, mode: str = "NCEP") -> List[str]:
    """One GRIB2 file per init time of the tree's input index (``paths`` as
    ``data.synthetic.generate_synthetic_dataset`` returns them); returns the files written."""
    with open(paths["input_map_file"], "rb") as fp:
        index = pickle.load(fp)
    lon, lat = _axes(paths["in_coord_file"])
    leads: Dict[str, set] = {}
    for key in index:
        m = re.fullmatch(r"GFS_(.+)_f(\d{3})_\w+", key)
        leads.setdefault(m.group(1), set()).add(int(m.group(2)))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for date_str, fhs in sorted(leads.items()):
        init = datetime.datetime.strptime(date_str, _DATE_FMT)
        messages = []
        for fh in sorted(fhs):
            def raster(var):
                return _raster(os.path.join(paths["input_path"], index[f"GFS_{date_str}_f{fh:03d}_{var}"] + ".tiff"))

            def message(code, type_of_level, level, values):
                return grib2.Grib2Message(discipline=code[0], param_category=code[1], param_number=code[2],
                                          ref_time=init, forecast_hours=fh, type_of_level=type_of_level,
                                          level=level, lat=lat[::-1], lon=lon,
                                          values=np.asarray(values, np.float64)[::-1])

            surface = {var: raster(var)[:, :, 0] for var in GRIB_SURFACE}
            surface["q2"] = dewpoint_from_specific_humidity(surface["PSFC"], surface["q2"])
            for var, (*code, type_of_level, level) in GRIB_SURFACE.items():
                messages.append(message(code, type_of_level, level, surface[var]))
            for var, code in GRIB_PRESSURE.items():
                stack = raster(var)
                for k, level in enumerate(PRESSURE_LEVELS):
                    messages.append(message(code, "isobaricInhPa", float(level), stack[:, :, k]))
        path = os.path.join(out_dir, f"GFS_{init:%Y%m%d%H}.grib2")
        grib2.write_messages(path, messages)
        written.append(path)
    return written


def _pack_int16(x: np.ndarray):
    """CDS-style int16 packing: (packed, scale_factor, add_offset), the values within
    +-32766 quanta of the offset."""
    lo, hi = float(x.min()), float(x.max())
    scale = (hi - lo) / 65532.0 if hi > lo else 1.0
    offset = (hi + lo) / 2.0
    return np.round((x - offset) / scale).astype(np.int16), scale, offset


def write_era5_netcdf(paths: Dict[str, str], out_dir: str) -> List[str]:
    """One classic NetCDF file per day of the tree's hourly labels; returns the files written."""
    lon, lat = _axes(paths["out_coord_file"])
    days: Dict[datetime.date, List[datetime.datetime]] = {}
    for f in glob.glob(os.path.join(paths["label_path"], "ERA5_*_PSFC.tiff")):
        t = datetime.datetime.strptime(os.path.basename(f)[5:-10], _DATE_FMT)
        days.setdefault(t.date(), []).append(t)
    os.makedirs(out_dir, exist_ok=True)
    epoch = datetime.datetime(1900, 1, 1)
    written = []
    for day, hours in sorted(days.items()):
        hours.sort()

        def cube(var):
            return np.stack([_raster(os.path.join(paths["label_path"], f"ERA5_{t.strftime(_DATE_FMT)}_{var}.tiff"))
                             [::-1, :, 0] for t in hours]).astype(np.float64)

        fields = {var: cube(var) for var in ERA5_NAMES}
        fields["q2"] = dewpoint_from_specific_humidity(fields["PSFC"], fields["q2"])
        dims = {"time": len(hours), "latitude": len(lat), "longitude": len(lon)}
        variables = [
            ("longitude", ("longitude",), lon.astype(np.float32), {"units": "degrees_east"}),
            ("latitude", ("latitude",), lat[::-1].astype(np.float32), {"units": "degrees_north"}),
            ("time", ("time",), np.array([(t - epoch) // datetime.timedelta(hours=1) for t in hours], np.int32),
             {"units": "hours since 1900-01-01 00:00:00.0", "calendar": "gregorian"}),
        ]
        for var, name in ERA5_NAMES.items():
            packed, scale, offset = _pack_int16(fields[var])
            variables.append((name, ("time", "latitude", "longitude"), packed,
                              {"scale_factor": np.float64(scale), "add_offset": np.float64(offset),
                               "_FillValue": np.int16(ERA5_FILL), "missing_value": np.int16(ERA5_FILL)}))
        path = os.path.join(out_dir, f"ERA5_{day:%Y%m%d}.nc")
        write_classic(path, dims, variables, {"Conventions": "CF-1.6"})
        written.append(path)
    return written
