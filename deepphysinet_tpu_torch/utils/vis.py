"""Field visualization: render a 2-D field to an image file.

Equivalent of VisUtils (utils/downscale_utils.py:25-89), which renders through
wrf-python map projections + basemap.  Neither is available here; projections
are implemented directly (LatLon identity, Mercator formula) through a small
registry (PROJECTIONS) and rendering uses matplotlib pcolormesh with the
study-area lat/lon from the coord pickle.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from deepphysinet_tpu_torch.registry import PROJECTIONS


@PROJECTIONS.register("LatLon")
class LatLonProjection:
    """Plate carree: x = lon, y = lat."""

    def __init__(self, **kwargs):
        pass

    def to_xy(self, lon: np.ndarray, lat: np.ndarray):
        return np.asarray(lon), np.asarray(lat)


@PROJECTIONS.register("Mercator")
class MercatorProjection:
    def __init__(self, stand_lon: float = 0.0, **kwargs):
        self.stand_lon = stand_lon

    def to_xy(self, lon: np.ndarray, lat: np.ndarray):
        x = np.deg2rad(np.asarray(lon) - self.stand_lon)
        y = np.log(np.tan(np.pi / 4 + np.deg2rad(np.asarray(lat)) / 2))
        return x, y


def build_project(name: str = "LatLon", **kwargs):
    return PROJECTIONS.build(name, **kwargs)


class VisUtils:
    """Render fields over the study-area grid (downscale_utils.py:25-89 surface)."""

    def __init__(
        self,
        coord_file: Optional[str] = None,
        project_dict: Optional[dict] = None,
        img_size: Optional[Tuple[int, int]] = None,
        cmap: str = "jet",
        landsea_file: Optional[str] = None,
    ):
        self.cmap = cmap
        project_dict = dict(project_dict or {"name": "LatLon"})
        self.projection = build_project(**project_dict)
        self.lon2d = self.lat2d = None
        if coord_file and os.path.exists(coord_file):
            with open(coord_file, "rb") as fp:
                lon, lat = pickle.load(fp)
            self.lon2d, self.lat2d = np.asarray(lon), np.asarray(lat)
        # coastline source: the study area's land/sea constant raster (the
        # same WPS-derived constant the dataset conditions on); its 0.5
        # contour IS the coastline.  Replaces the reference's basemap
        # ``drawcoastlines`` (downscale_utils.py:60-63) without needing GSHHS.
        self.landsea = None
        if landsea_file and os.path.exists(landsea_file):
            from deepphysinet_tpu_torch.data.geotiff import read_tiff

            img, _ = read_tiff(landsea_file)
            ls = img[:, :, 0].astype(np.float32)
            if ls.max() > ls.min():  # flat raster -> nothing to contour
                self.landsea = ls

    def _draw_coastlines(self, ax, data_shape) -> None:
        """Overlay the landsea 0.5-contour, mapped onto the render's axes.

        The landsea raster lives on the coarse input grid; both grids span
        the same bounding box, so linspace over the render's extent places
        it exactly.
        """
        if self.landsea is None:
            return
        h, w = self.landsea.shape
        if self.lon2d is not None and self.lon2d.shape == data_shape:
            lons = np.linspace(self.lon2d.min(), self.lon2d.max(), w)
            lats = np.linspace(self.lat2d.min(), self.lat2d.max(), h)
            gx, gy = np.meshgrid(lons, lats)
            x, y = self.projection.to_xy(gx, gy)
        else:
            x = np.linspace(0, data_shape[1] - 1, w)
            y = np.linspace(0, data_shape[0] - 1, h)
        ax.contour(x, y, self.landsea, levels=[0.5], colors="k",
                   linewidths=0.8, alpha=0.9)

    def forward(self, data: np.ndarray, out_file: str, title: Optional[str] = None) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        data = np.asarray(data)
        fig, ax = plt.subplots(figsize=(8, 5), dpi=110)
        if self.lon2d is not None and self.lon2d.shape == data.shape:
            x, y = self.projection.to_xy(self.lon2d, self.lat2d)
            im = ax.pcolormesh(x, y, data, cmap=self.cmap, shading="auto")
        else:
            im = ax.imshow(data, origin="lower", cmap=self.cmap, aspect="auto")
        self._draw_coastlines(ax, data.shape)
        fig.colorbar(im, ax=ax, shrink=0.85)
        if title:
            ax.set_title(title)
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        fig.savefig(out_file, bbox_inches="tight")
        plt.close(fig)
