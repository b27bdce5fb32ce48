"""Coordinate engine: grid geometry and coordinate encoding.

Counterpart of ``deepphysinet_tpu/ops/coords.py``: physical (x, y, t) in
meters/seconds normalized by (dx*(lon_size-1), dy*(lat_size-1), pred_t_span)
and SineCos-encoded (3 input dims, 32 freqs -> 192 features).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe

OMEGA = 7.29e-5  # Earth's rotation rate, reference dataset/physics_dataset.py:522


@dataclasses.dataclass(frozen=True)
class CoordSpec:
    """Static geometry of the output grid."""

    lon_size: int  # output grid columns (257 on the 0.25-degree grid)
    lat_size: int  # output grid rows (145)
    dx: float  # meters per output grid step (27000)
    dy: float
    pred_t_span: float  # seconds covered by one input window (86400)
    n_freqs: int = 32
    max_freq: float = 4.0

    def freq_bands(self) -> np.ndarray:
        return make_freq_bands(self.n_freqs, self.max_freq)


def encode_coord(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor, spec: CoordSpec) -> torch.Tensor:
    """Normalize physical coords and encode them; [N] or [N, 1] each -> [N, 192]."""
    xn = x / spec.dx / (spec.lon_size - 1)
    yn = y / spec.dy / (spec.lat_size - 1)
    tn = t / spec.pred_t_span
    if xn.ndim <= 1:
        coords = torch.stack([xn, yn, tn], dim=-1)
    else:
        coords = torch.cat([xn, yn, tn], dim=-1)
    return sinecos_pe(coords, spec.freq_bands())


def coriolis(lat_deg: torch.Tensor) -> torch.Tensor:
    """f = 2 Omega sin(lat), [N] -> [N, 1] (reference dataset/physics_dataset.py:521-526)."""
    f = 2.0 * OMEGA * torch.sin(lat_deg / 180.0 * torch.pi)
    return f[:, None] if f.ndim == 1 else f


def make_latlon_grid(
    lon0: float = 72.0,
    lat0: float = 18.0,
    lon1: float = 136.0,
    lat1: float = 54.0,
    step: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Study-area meshgrid (lon2d, lat2d); lat ascends from the south (row 0 = lat0)."""
    lons = np.arange(lon0, lon1 + step / 2, step, dtype=np.float64)
    lats = np.arange(lat0, lat1 + step / 2, step, dtype=np.float64)
    lon2d, lat2d = np.meshgrid(lons, lats)
    return lon2d, lat2d


def save_coord_pickle(path: str, lon2d: np.ndarray, lat2d: np.ndarray) -> None:
    """Write a (lon2d, lat2d) coord pickle, the layout of auxiliary_data/coord_*.pickle."""
    with open(path, "wb") as fp:
        pickle.dump((lon2d, lat2d), fp)


def load_coord_pickle(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a (lon2d, lat2d) coord pickle (dataset/physics_dataset.py:98-105)."""
    with open(path, "rb") as fp:
        lon, lat = pickle.load(fp)
    return np.asarray(lon), np.asarray(lat)
