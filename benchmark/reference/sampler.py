"""The training points of one step, worked out from a window's cubes and the step's draws.

Geometry: the label grid is ``img_size`` (145 x 257) at 0.25 degrees from (72 E, 18 N), with one
slice an hour over the 24 h window (25); the NWP grid covers the same box at 1 degree (37 x 65)
with one slice every 6 h (5).  Both cubes are channel-last row tables ``[H * W * T, 6]``, row
``(y * W + x) * T + t``.  A step's margin points sit on the label grid (integer x, y and hour),
its collocation points anywhere in the box at whole hours; the NWP conditioning of either is
the trilinear interpolation of the NWP cube.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

from benchmark.reference.physics import coriolis


class Geometry(NamedTuple):
    Hl: int
    Wl: int
    Tl: int
    Hc: int
    Wc: int
    Tc: int
    dx: float
    dy: float
    window_h: int
    input_step_h: int
    label_step_h: int
    lon0: float = 72.0
    lat0: float = 18.0
    fine_deg: float = 0.25
    coarse_deg: float = 1.0
    t_span_s: float = 86400.0
    lead_period_h: float = 360.0


def geometry(config: Mapping) -> Geometry:
    train = config["train_cfg"]
    data = train["train_data"]
    Hl, Wl = (int(v) for v in train["img_size"])
    window_h = int(data["input_time_step"]) * int(data["input_time_step_nums"])
    label_step = int(data["label_time_step"])
    return Geometry(Hl=Hl, Wl=Wl, Tl=window_h // label_step + 1, Hc=(Hl - 1) // 4 + 1, Wc=(Wl - 1) // 4 + 1,
                    Tc=window_h // int(data["input_time_step"]) + 1, dx=float(train["dx"]), dy=float(train["dy"]),
                    window_h=window_h, input_step_h=int(data["input_time_step"]), label_step_h=label_step,
                    lead_period_h=float(data["forecast_time_period"]))


def trilinear(rows: torch.Tensor, g: Geometry, lon: torch.Tensor, lat: torch.Tensor,
              hours: torch.Tensor) -> torch.Tensor:
    """The NWP row table [Hc * Wc * Tc, 6] at points (degrees, hours) -> [N, 6], in the points'
    floating type."""
    H, W, T = g.Hc, g.Wc, g.Tc
    dtype = lon.dtype
    rows = rows.to(dtype)
    fy = torch.clamp((lat - g.lat0) / g.coarse_deg, 0.0, H - 1.0)
    fx = torch.clamp((lon - g.lon0) / g.coarse_deg, 0.0, W - 1.0)
    ft = torch.clamp(hours / g.input_step_h, 0.0, T - 1.0)
    y0 = torch.clamp(torch.floor(fy).long(), 0, H - 2)
    x0 = torch.clamp(torch.floor(fx).long(), 0, W - 2)
    t0 = torch.clamp(torch.floor(ft).long(), 0, T - 2)
    wy, wx, wt = ((f - i.to(dtype))[:, None] for f, i in ((fy, y0), (fx, x0), (ft, t0)))
    out = torch.zeros(lon.shape[0], rows.shape[1], dtype=dtype, device=lon.device)
    for dy_, ay in ((0, 1 - wy), (1, wy)):
        for dx_, ax in ((0, 1 - wx), (1, wx)):
            for dt_, at in ((0, 1 - wt), (1, wt)):
                out = out + ay * ax * at * rows[((y0 + dy_) * W + (x0 + dx_)) * T + (t0 + dt_)]
    return out


def margin_points(window: Mapping, draws: Mapping, g: Geometry) -> Dict[str, torch.Tensor]:
    """Labelled points: coords [N, 3] physical (m, m, s), nwp [N, 6], labels [N, 6], f [N]."""
    mx, my, slot = draws["mx"], draws["my"], draws["slot"]
    labels = window["label_rows"][(my * g.Wl + mx) * g.Tl + slot]
    lon = g.lon0 + mx.float() * g.fine_deg
    lat = g.lat0 + my.float() * g.fine_deg
    hours = (slot * g.label_step_h).float()
    nwp = trilinear(window["nwp_rows"], g, lon, lat, hours)
    coords = torch.stack([mx.float() * g.dx, my.float() * g.dy, hours * 3600.0], dim=-1)
    return dict(coords=coords, nwp=nwp, labels=labels.float(), f=coriolis(lat))


def inter_points(window: Mapping, draws: Mapping, g: Geometry) -> Dict[str, torch.Tensor]:
    """Collocation points: coords [N, 3], nwp [N, 6], f [N]."""
    xi = draws["ix"] * (g.Wl - 1)
    yi = draws["iy"] * (g.Hl - 1)
    hours = draws["it"].float()
    lon = g.lon0 + xi * g.fine_deg
    lat = g.lat0 + yi * g.fine_deg
    nwp = trilinear(window["nwp_rows"], g, lon, lat, hours)
    coords = torch.stack([xi * g.dx, yi * g.dy, hours * 3600.0], dim=-1)
    return dict(coords=coords, nwp=nwp, f=coriolis(lat))


def normalized(coords: torch.Tensor, g: Geometry) -> torch.Tensor:
    scale = torch.tensor([g.dx * (g.Wl - 1), g.dy * (g.Hl - 1), g.t_span_s], dtype=coords.dtype,
                         device=coords.device)
    return coords / scale
