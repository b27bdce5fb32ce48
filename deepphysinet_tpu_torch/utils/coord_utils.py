"""CoordUtils: lon/lat <-> fractional grid-index conversions.

The port's own copy of ``deepphysinet_tpu/utils/coord_utils.py`` (numpy only, unchanged), so that
the port imports nothing of the JAX package.

Port of utils/utils.py:26-61, with numpy interpolation replacing the
per-call xarray DataArray.interp.  Given a coord pickle (lon2d, lat2d), maps
geographic coordinates to fractional (x, y) grid indices and back -- used for
station-point inference and label placement.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np


class CoordUtils:
    def __init__(self, coord_file: str):
        with open(coord_file, "rb") as fp:
            self.lon, self.lat = pickle.load(fp)
        self.lon = np.asarray(self.lon)
        self.lat = np.asarray(self.lat)
        self.lat_size, self.lon_size = self.lon.shape[:2]
        self._lon_axis = self.lon[0, :]
        self._lat_axis = self.lat[:, 0]

    def geo2xy(self, ref_lon, ref_lat) -> Tuple[np.ndarray, np.ndarray]:
        """(lon, lat) -> fractional grid indices (x, y)."""
        x = np.interp(np.asarray(ref_lon, np.float64), self._lon_axis,
                      np.arange(self.lon_size, dtype=np.float64))
        y = np.interp(np.asarray(ref_lat, np.float64), self._lat_axis,
                      np.arange(self.lat_size, dtype=np.float64))
        return x, y

    def xy2geo(self, ref_x, ref_y, size_t) -> Tuple[np.ndarray, np.ndarray]:
        """Fractional indices on a (possibly different-resolution) grid of
        shape ``size_t`` -> (lon, lat)."""
        if not isinstance(size_t, (list, tuple)):
            size_t = (size_t, size_t)
        lat_size, lon_size = size_t
        fx = np.asarray(ref_x, np.float64) / (lon_size - 1)
        fy = np.asarray(ref_y, np.float64) / (lat_size - 1)
        lon = np.interp(fx, np.linspace(0, 1, self.lon_size), self._lon_axis)
        lat = np.interp(fy, np.linspace(0, 1, self.lat_size), self._lat_axis)
        return lon, lat
