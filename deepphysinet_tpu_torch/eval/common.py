"""What the evaluation sweeps share: the label grid of a window on the device,
the per-hour conditioning and coordinates, and a window's arrays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.interp import trilinear_interp_cube


def n_windows(windows: Sequence, max_windows: Optional[int]) -> int:
    return len(windows) if max_windows is None else min(max_windows, len(windows))


@dataclasses.dataclass
class LabelGrid:
    """Every point of a window's label grid, row-major, as tensors on the device."""

    shape: Tuple[int, int]  # (lat, lon) of the label grid
    x_m: torch.Tensor  # [N] meters
    y_m: torch.Tensor
    lon: torch.Tensor  # [N] degrees
    lat: torch.Tensor

    @classmethod
    def of(cls, window, device) -> "LabelGrid":
        h, w = len(window.out_lat), len(window.out_lon)
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        xf, yf = xs.reshape(-1), ys.reshape(-1)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        return cls(shape=(h, w), x_m=put(xf * window.dx), y_m=put(yf * window.dy),
                   lon=put(window.begin_lon + xf * window.fine_lon_step),
                   lat=put(window.begin_lat + yf * window.fine_lat_step))

    def coords(self, t_hour: float) -> torch.Tensor:
        """Physical (x m, y m, t s) of every grid point at one hour -> [N, 3]."""
        t_sec = torch.full_like(self.x_m, 3600.0) * t_hour
        return torch.stack([self.x_m, self.y_m, t_sec], dim=-1)

    def conditioning(self, window, cube6: torch.Tensor, t_hour: float) -> torch.Tensor:
        """The window's NWP cube [6, H, W, T] (on the device) interpolated to every
        grid point at one hour -> [N, 6]."""
        return trilinear_interp_cube(
            cube6, self.lon, self.lat, torch.full_like(self.lon, t_hour),
            lon0=float(window.in_lon[0]), dlon=float(window.in_lon[1] - window.in_lon[0]),
            lat0=float(window.in_lat[0]), dlat=float(window.in_lat[1] - window.in_lat[0]),
            t0=0.0, dt=float(window.input_time_step)).t()


@torch.no_grad()
def encode_window(model, window, device):
    """``(tokens [T, D], fh_norm [1], cube6 [6, H, W, T])`` of one window on the device."""
    field = torch.as_tensor(np.asarray(window.field, np.float32)).to(device)[None]
    fh_norm = torch.tensor([window.forecast_h / window.forecast_time_period],
                           dtype=torch.float32, device=device)
    tokens = model.encode(field, fh_norm[None, :])[0]
    cube6 = torch.as_tensor(np.asarray(window.nwp_cube, np.float32)).to(device)
    return tokens, fh_norm, cube6
