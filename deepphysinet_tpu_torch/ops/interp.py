"""Trilinear interpolation of coarse NWP cubes to scattered points, on the device.

Counterpart of ``_gather_trilinear`` and ``trilinear_interp_cube`` in
``deepphysinet_tpu/ops/interp.py`` (:21-80): the window cube
``[6 variables, H, W, T]`` lies on the device and the gather and the lerps run
there in float32, with the same clipping and the same corner order.  Grids are
uniform, so the coordinate lookup is a closed-form fractional index.  The
table / rows forms of the JAX module (:83-229) are not ported yet.
"""

from __future__ import annotations

import torch


def _gather_trilinear(cube: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                      ft: torch.Tensor) -> torch.Tensor:
    """cube: [..., H, W, T]; fy / fx / ft: fractional indices [N] -> [..., N]."""
    H, W, T = cube.shape[-3:]
    fy = torch.clamp(fy, 0.0, H - 1.0)
    fx = torch.clamp(fx, 0.0, W - 1.0)
    ft = torch.clamp(ft, 0.0, T - 1.0)

    def lower(f, size):
        if size == 1:
            return torch.zeros_like(f, dtype=torch.int64)
        return torch.clamp(torch.floor(f).to(torch.int64), 0, size - 2)

    y0, x0, t0 = lower(fy, H), lower(fx, W), lower(ft, T)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    t1 = torch.clamp(t0 + 1, max=T - 1)
    wy, wx, wt = fy - y0, fx - x0, ft - t0

    flat = cube.reshape(cube.shape[:-3] + (H * W * T,))  # one gather per corner

    def take(yi, xi, ti):
        return flat[..., (yi * W + xi) * T + ti]  # [..., N]

    c00 = take(y0, x0, t0) * (1 - wt) + take(y0, x0, t1) * wt
    c01 = take(y0, x1, t0) * (1 - wt) + take(y0, x1, t1) * wt
    c10 = take(y1, x0, t0) * (1 - wt) + take(y1, x0, t1) * wt
    c11 = take(y1, x1, t0) * (1 - wt) + take(y1, x1, t1) * wt
    c0 = c00 * (1 - wx) + c01 * wx
    c1 = c10 * (1 - wx) + c11 * wx
    return c0 * (1 - wy) + c1 * wy


def trilinear_interp_cube(cube: torch.Tensor, lon_pts: torch.Tensor, lat_pts: torch.Tensor,
                          t_pts: torch.Tensor, lon0: float, dlon: float, lat0: float,
                          dlat: float, t0: float = 0.0, dt: float = 6.0) -> torch.Tensor:
    """Interpolate ``cube[..., H, W, T]`` at scattered (lon, lat, t) points -> [..., N].

    ``t_pts`` in the unit of the cube's time axis (hours)."""
    fy = (lat_pts - lat0) / dlat
    fx = (lon_pts - lon0) / dlon
    ft = (t_pts - t0) / dt
    return _gather_trilinear(cube, fy.float(), fx.float(), ft.float())
