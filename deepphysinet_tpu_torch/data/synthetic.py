"""Synthetic dataset generator in the reference's on-disk layout.

Writes a miniature TIGGE/ERA5-style tree -- GFS input tiffs + index pickle,
ERA5 label tiffs, constant fields, coord pickles -- so the full pipeline
(indexing, token packing, sampling, training, inference) runs hermetically in
tests and benchmarks.  Fields are smooth space-time harmonics around each
variable's climatological mean, so a coordinate MLP can actually fit them and
physical-unit magnitudes stay realistic.

Layout produced (mirrors README dataset instructions + physics_dataset.py):
  root/
    input/NCEP/<year>/GFS_%Y-%m-%d-%H-%M-%S_f%03d_<var>.tiff
    labels/ERA5_%Y-%m-%d-%H-%M-%S_<var>.tiff
    constant/{landsea,elevation,lat,lon}.tiff
    coord_1d.pickle, coord_0p25d.pickle, input_map.pickle
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Dict, Tuple

import numpy as np

import functools

from deepphysinet_tpu_torch.data.geotiff import write_tiff as _write_tiff

# the reference ETL tools emit TILED=TRUE COMPRESS=DEFLATE rasters
# (tools/extract_variable_from_nc.py:34); the synthetic tree matches that
# byte format so every dataset/e2e test exercises the real ingest path
write_tiff = functools.partial(_write_tiff, compression="deflate", tiled=True,
                               tile_size=16)
from deepphysinet_tpu_torch.ops.coords import make_latlon_grid, save_coord_pickle

_DATE_FMT = "%Y-%m-%d-%H-%M-%S"

# (mean, amplitude) per surface variable in physical units
_SURFACE = {
    "PSFC": (9.0e4, 800.0),
    "t2": (284.0, 8.0),
    "u10": (0.3, 4.0),
    "v10": (-0.1, 4.0),
    "q2": (0.0076, 0.003),
    "rio": (1.09, 0.08),
}
SYNTH_VERSION = "3"


def synthetic_tree_is_current(root: str) -> bool:
    """True if ``root`` holds a tree from THIS generator version."""
    import os as _os

    marker = _os.path.join(root, "SYNTH_VERSION")
    try:
        with open(marker) as fp:
            return fp.read().strip() == SYNTH_VERSION
    except OSError:
        return False


def ensure_synthetic_tree(root: str, **gen_kwargs) -> None:
    """Regenerate ``root`` iff stale, safely across concurrent processes.

    Configs call this at import time, and multi-process launches (e.g. the
    2-process trainer test) import the same config concurrently: without a
    lock, both processes could see a stale tree and rmtree the files the
    other is mid-writing.  An exclusive flock on ``<root>.lock`` serializes
    the stale-check + rmtree + generate; the version marker is written last
    by the generator, so a killed regeneration stays "stale" and is redone."""
    import fcntl
    import os as _os
    import shutil

    if synthetic_tree_is_current(root):
        return
    _os.makedirs(_os.path.dirname(_os.path.abspath(root)) or ".", exist_ok=True)
    with open(root.rstrip("/\\") + ".lock", "w") as lock_fp:
        fcntl.flock(lock_fp, fcntl.LOCK_EX)
        try:
            if synthetic_tree_is_current(root):  # a peer regenerated first
                return
            shutil.rmtree(root, ignore_errors=True)  # stale generator version
            generate_synthetic_dataset(root, **gen_kwargs)
        finally:
            fcntl.flock(lock_fp, fcntl.LOCK_UN)


# per-level (1000/925/850/700/500 hPa) means where the vertical structure
# matters: GHT must ascend hydrostatically (vertical-interpolation products
# -- slp/t2/10m winds -- extrapolate over it), TT follows a lapse rate, QQ
# decays with height and must stay positive
_PRESSURE = {
    "GHT": ([100.0, 770.0, 1478.0, 3067.0, 5699.0], 100.0),
    "TT": ([292.0, 288.0, 284.0, 275.0, 259.0], 6.0),
    "UU": ([0.4, 0.8, 1.9, 4.8, 10.1], 4.0),
    "VV": ([0.04, 0.18, 0.1, -0.42, -0.95], 4.0),
    "QQ": ([0.009, 0.008, 0.006, 0.004, 0.002],
           [0.003, 0.0027, 0.002, 0.0013, 0.0006]),
}


def _field(name: str, lon2d, lat2d, hours: float, levels: int = 1, seed: int = 0) -> np.ndarray:
    """Smooth deterministic space-time harmonic field [H, W, levels]."""
    mean, amp = (_SURFACE.get(name) or _PRESSURE[name])
    h, w = lon2d.shape
    # stable digest, NOT hash(): str hashing is salted per process, which made
    # "identical" trees differ between generating processes (tests comparing
    # results across trees flaked on the draw)
    import zlib

    rs = np.random.RandomState(zlib.crc32(name.encode()) % (2**31) + seed)
    out = np.zeros((h, w, levels), np.float64)
    for lev in range(levels):
        mean_l = mean[lev] if isinstance(mean, (list, tuple)) else mean
        amp_l = amp[lev] if isinstance(amp, (list, tuple)) else amp
        ph1, ph2, ph3 = rs.rand(3) * 2 * np.pi
        k1, k2 = rs.randint(1, 4, 2)
        f = (
            np.sin(k1 * np.deg2rad(lon2d) * 6 + ph1 + hours / 24.0)
            + np.cos(k2 * np.deg2rad(lat2d) * 6 + ph2 - hours / 17.0)
            + 0.5 * np.sin(np.deg2rad(lon2d + lat2d) * 8 + ph3 + hours / 9.0)
        ) / 2.5
        out[:, :, lev] = mean_l + amp_l * f * (1 - 0.08 * lev)
    return out.astype(np.float32)


def generate_synthetic_dataset(
    root: str,
    n_init_times: int = 2,
    start: str = "2008-01-01_00_00_00",
    forecast_leads=(0,),
    mode: str = "NCEP",
    coarse_step: float = 1.0,
    fine_step: float = 0.25,
    bbox: Tuple[float, float, float, float] = (72.0, 18.0, 136.0, 54.0),
    input_time_step: int = 6,
    input_time_step_nums: int = 4,
    seed: int = 0,
) -> Dict[str, str]:
    """Build the tree; returns the path dict a config needs."""
    lon0, lat0, lon1, lat1 = bbox
    in_lon2d, in_lat2d = make_latlon_grid(lon0, lat0, lon1, lat1, coarse_step)
    out_lon2d, out_lat2d = make_latlon_grid(lon0, lat0, lon1, lat1, fine_step)

    input_dir = os.path.join(root, "input")
    label_dir = os.path.join(root, "labels")
    const_dir = os.path.join(root, "constant")
    os.makedirs(label_dir, exist_ok=True)
    os.makedirs(const_dir, exist_ok=True)

    in_coord = os.path.join(root, "coord_1d.pickle")
    out_coord = os.path.join(root, "coord_0p25d.pickle")
    save_coord_pickle(in_coord, in_lon2d, in_lat2d)
    save_coord_pickle(out_coord, out_lon2d, out_lat2d)

    # constants
    h, w = in_lon2d.shape
    rs = np.random.RandomState(seed)
    write_tiff(os.path.join(const_dir, "landsea.tiff"),
               (rs.rand(h, w) > 0.4).astype(np.float32))
    write_tiff(os.path.join(const_dir, "elevation.tiff"),
               (np.abs(np.sin(in_lon2d / 7) * np.cos(in_lat2d / 5)) * 2500).astype(np.float32))
    write_tiff(os.path.join(const_dir, "lat.tiff"), in_lat2d.astype(np.float32))
    write_tiff(os.path.join(const_dir, "lon.tiff"), in_lon2d.astype(np.float32))

    start_dt = datetime.datetime.strptime(start, "%Y-%m-%d_%H_%M_%S")
    window_h = input_time_step * input_time_step_nums
    input_map: Dict[str, str] = {}

    for it in range(n_init_times):
        init = start_dt + datetime.timedelta(hours=24 * it)
        date_str = init.strftime(_DATE_FMT)
        year = str(init.year)
        year_dir = os.path.join(input_dir, mode, year)
        os.makedirs(year_dir, exist_ok=True)
        for lead in forecast_leads:
            for i in range(input_time_step_nums + 1):
                fh = lead + i * input_time_step
                abs_hours = (init - start_dt).total_seconds() / 3600 + fh
                for var in _SURFACE:
                    name = f"GFS_{date_str}_f{fh:03d}_{var}"
                    write_tiff(os.path.join(year_dir, f"{name}.tiff"),
                               _field(var, in_lon2d, in_lat2d, abs_hours, 1, seed))
                    input_map[name] = f"{mode}/{year}/{name}"
                for var in _PRESSURE:
                    name = f"GFS_{date_str}_f{fh:03d}_{var}"
                    write_tiff(os.path.join(year_dir, f"{name}.tiff"),
                               _field(var, in_lon2d, in_lat2d, abs_hours, 5, seed))
                    input_map[name] = f"{mode}/{year}/{name}"
            # hourly ERA5 labels covering the window
            for t in range(0, window_h + 1):
                ref = init + datetime.timedelta(hours=lead + t)
                abs_hours = (ref - start_dt).total_seconds() / 3600
                for var in _SURFACE:
                    lf = os.path.join(label_dir, f"ERA5_{ref.strftime(_DATE_FMT)}_{var}.tiff")
                    if not os.path.exists(lf):
                        write_tiff(lf, _field(var, out_lon2d, out_lat2d, abs_hours, 1, seed))

    map_file = os.path.join(root, "input_map.pickle")
    with open(map_file, "wb") as fp:
        pickle.dump(input_map, fp)
    # generator-version marker: configs regenerate stale cached trees (the
    # vertical structure of the pressure variables changed in v2)
    with open(os.path.join(root, "SYNTH_VERSION"), "w") as fp:
        fp.write(SYNTH_VERSION)

    return {
        "input_path": input_dir,
        "label_path": label_dir,
        "constant_path": const_dir,
        "in_coord_file": in_coord,
        "out_coord_file": out_coord,
        "input_map_file": map_file,
        "img_size": out_lon2d.shape,
        "in_img_size": in_lon2d.shape,
    }
