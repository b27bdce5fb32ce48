"""Trilinear interpolation of coarse NWP cubes to scattered points, on the device.

Counterpart of ``deepphysinet_tpu/ops/interp.py``: the window cube lies on the device and the
gather and the lerps run there in float32, with the same clipping, the same corner order and the
same lerp order.  Grids are uniform, so the coordinate lookup is a closed-form fractional index.

Two layouts:

* the cube form (``trilinear_interp_cube``): a channel-first cube ``[..., H, W, T]``, one gather
  per corner and variable (the evaluation sweeps' conditioning);
* the row-table forms (``trilinear_interp_table``, ``trilinear_interp_rows`` and their batched
  forms): a channel-last cube flattened to rows ``[H*W*T, C]``, one row gather per corner, so that
  a point's C variables come together (the device-side sampler, ``train/device_sampling.py``).
  The batched forms fold the window index into the absolute row ``b*H*W*T + flat``.
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


def _rows_weights(fy, fx, ft, H: int, W: int, T: int):
    """Corner indices and lerp weights of the row-table forms."""
    fy = torch.clamp(fy, 0.0, H - 1.0).float()
    fx = torch.clamp(fx, 0.0, W - 1.0).float()
    ft = torch.clamp(ft, 0.0, T - 1.0).float()

    def lower(f, size):
        if size == 1:
            return torch.zeros_like(f, dtype=torch.int64)
        return torch.clamp(torch.floor(f).to(torch.int64), 0, size - 2)

    y0, x0, t0 = lower(fy, H), lower(fx, W), lower(ft, T)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    t1 = torch.clamp(t0 + 1, max=T - 1)
    return (y0, x0, t0, y1, x1, t1), (fy - y0, fx - x0, ft - t0)


def _lerp_rows(take, corners, weights):
    """Trilinear lerp over 8 row-gathered corners; the weights get a trailing channel axis, so
    that ``[..., N, C]`` corners broadcast."""
    y0, x0, t0, y1, x1, t1 = corners
    wy, wx, wt = (w[..., None] for w in weights)
    c00 = take(y0, x0, t0) * (1 - wt) + take(y0, x0, t1) * wt
    c01 = take(y0, x1, t0) * (1 - wt) + take(y0, x1, t1) * wt
    c10 = take(y1, x0, t0) * (1 - wt) + take(y1, x0, t1) * wt
    c11 = take(y1, x1, t0) * (1 - wt) + take(y1, x1, t1) * wt
    c0 = c00 * (1 - wx) + c01 * wx
    c1 = c10 * (1 - wx) + c11 * wx
    return c0 * (1 - wy) + c1 * wy


def trilinear_interp_table(table: torch.Tensor, dims, lon_pts: torch.Tensor, lat_pts: torch.Tensor,
                           t_pts: torch.Tensor, lon0: float, dlon: float, lat0: float, dlat: float,
                           t0: float = 0.0, dt: float = 6.0) -> torch.Tensor:
    """Row-table interpolation: ``table`` [H*W*T, C] (the channel-last rows of a cube on the grid
    ``dims`` = (H, W, T)) at N points -> [N, C]."""
    H, W, T = dims
    corners, weights = _rows_weights((lat_pts - lat0) / dlat, (lon_pts - lon0) / dlon, (t_pts - t0) / dt,
                                     H, W, T)

    def take(yi, xi, ti):
        return table.index_select(0, (yi * W + xi) * T + ti)  # [N, C]

    return _lerp_rows(take, corners, weights)


def trilinear_interp_table_batched(table: torch.Tensor, dims, lon_pts: torch.Tensor, lat_pts: torch.Tensor,
                                   t_pts: torch.Tensor, lon0: float, dlon: float, lat0: float, dlat: float,
                                   t0: float = 0.0, dt: float = 6.0) -> torch.Tensor:
    """``trilinear_interp_table`` for a batch of windows: ``table`` [B*H*W*T, C] window-major
    rows, points [B, N] -> [B, N, C]; window b's rows start at ``b*H*W*T``."""
    H, W, T = dims
    off = (torch.arange(lon_pts.shape[0], device=table.device) * (H * W * T))[:, None]  # [B, 1]
    corners, weights = _rows_weights((lat_pts - lat0) / dlat, (lon_pts - lon0) / dlon, (t_pts - t0) / dt,
                                     H, W, T)
    N, C = lon_pts.shape[-1], table.shape[-1]

    def take(yi, xi, ti):
        idx = (yi * W + xi) * T + ti + off  # [B, N]
        return table.index_select(0, idx.reshape(-1)).reshape(-1, N, C)

    return _lerp_rows(take, corners, weights)


def trilinear_interp_rows(cube: torch.Tensor, lon_pts: torch.Tensor, lat_pts: torch.Tensor, t_pts: torch.Tensor,
                          lon0: float, dlon: float, lat0: float, dlat: float, t0: float = 0.0,
                          dt: float = 6.0) -> torch.Tensor:
    """A channel-last cube [H, W, T, C] at N points -> [N, C], through ``trilinear_interp_table``."""
    H, W, T = cube.shape[-4:-1]
    return trilinear_interp_table(cube.reshape(H * W * T, cube.shape[-1]), (H, W, T), lon_pts, lat_pts, t_pts,
                                  lon0, dlon, lat0, dlat, t0, dt)


def trilinear_interp_rows_batched(cube: torch.Tensor, lon_pts: torch.Tensor, lat_pts: torch.Tensor,
                                  t_pts: torch.Tensor, lon0: float, dlon: float, lat0: float, dlat: float,
                                  t0: float = 0.0, dt: float = 6.0) -> torch.Tensor:
    """Channel-last cubes [B, H, W, T, C] at points [B, N] -> [B, N, C], through
    ``trilinear_interp_table_batched``."""
    B = cube.shape[0]
    H, W, T = cube.shape[-4:-1]
    return trilinear_interp_table_batched(cube.reshape(B * H * W * T, cube.shape[-1]), (H, W, T), lon_pts,
                                          lat_pts, t_pts, lon0, dlon, lat0, dlat, t0, dt)
