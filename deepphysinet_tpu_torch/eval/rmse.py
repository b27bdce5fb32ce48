"""ERA5-validation RMSE (T2m / U10 / V10 / PSFC / q2 / rho).

Counterpart of ``deepphysinet_tpu/eval/rmse.py``:

* ``evaluate_rmse_fullgrid`` (:133-257), over a sequence of ``data.window.Window`` (for a
  ``PhysicsDataset``, ``data.window.DatasetWindows``) where the JAX function takes the dataset.  Per
  window: one encode, then a Python loop over the labelled hours (a ``lax.scan`` in JAX), each of
  which interpolates the NWP cube to every label-grid point on the device, decodes them through the
  var-major collapsed primal decode (``physics/engine.py::collapsed_decode_t``, the Hopper kernel on
  a GPU) and sums squared error and bias in physical units on the device; one device-to-host read
  per window.
* ``evaluate_rmse`` (:63-130), the subsampled estimate: per window up to ``points_per_window`` of
  the dataset's sampled margin points (or points drawn from the window's cubes,
  ``_cube_eval_item``), through the plain per-variable ``PhysicsNet.decode``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deepphysinet_tpu_torch.device import model_device
from deepphysinet_tpu_torch.eval.common import LabelGrid, encode_window, n_windows
from deepphysinet_tpu_torch.ops.coords import encode_coord
from deepphysinet_tpu_torch.physics.engine import collapsed_decode_t
from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack, inverse_norm_stack_t

VAR_NAMES = ("u10", "v10", "pres", "t2", "q2", "rio")


def _cube_eval_item(dataset, w: int, n: int, rng) -> dict:
    """Margin-shaped evaluation points drawn from window w's cubes (JAX :31-60): exact label
    gathers on the fine grid, the NWP conditioning interpolated at the drawn points."""
    item_c = dataset.get_cube_item(w)
    label_cube = np.asarray(item_c["label_cube"])  # [6, Hl, Wl, Tl]
    _, hl, wl, tl = label_cube.shape
    n = min(n, hl * wl * tl)
    xs = rng.randint(0, wl, n)
    ys = rng.randint(0, hl, n)
    slot = rng.randint(0, tl, n)
    t_h = slot * float(dataset.label_time_step)
    lon = dataset.begin_lon + xs * float(dataset.out_lon[1] - dataset.out_lon[0])
    lat = dataset.begin_lat + ys * float(dataset.out_lat[1] - dataset.out_lat[0])
    return {
        "field_data": item_c["field_data"],
        "forecast_h": item_c["forecast_h"],
        "margin_x": (xs * dataset.dx).astype(np.float32),
        "margin_y": (ys * dataset.dy).astype(np.float32),
        "margin_t": (t_h * 3600.0).astype(np.float32),
        "margin_data": label_cube[:, ys, xs, slot].T.astype(np.float32),
        "margin_input_data": np.asarray(dataset._interp_cube_at(item_c["nwp_cube"], lon, lat, t_h), np.float32),
    }


@torch.no_grad()
def evaluate_rmse(model, cfg, dataset, max_windows: Optional[int] = None, points_per_window: int = 20480,
                  seed: int = 0, from_cubes: Optional[bool] = None, device=None) -> Dict[str, float]:
    """Subsampled per-variable RMSE and bias (physical units) over held-out windows: up to
    ``points_per_window`` of each window's sampled margin points (``dataset[w]``), re-drawn with a
    ``RandomState(seed)``, through the plain per-variable decode.  ``from_cubes`` (default: on when
    the dataset samples on the device) draws the points from the window's cubes instead.  The run
    is on ``device``: the first CUDA device when ``None`` (an error without one), and the model must
    already be there.  For the exhaustive sweep use ``evaluate_rmse_fullgrid``."""
    dev = model_device(model, device)
    rng = np.random.RandomState(seed)
    if from_cubes is None:
        from_cubes = getattr(dataset, "sample_mode", "host") == "device"
    sq_sum, bias_sum, count = np.zeros(6, np.float64), np.zeros(6, np.float64), 0
    n_win = n_windows(dataset, max_windows)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    for w in range(n_win):
        item = _cube_eval_item(dataset, w, points_per_window, rng) if from_cubes else dataset[w]
        n = min(points_per_window, len(item["margin_x"]))
        sel = rng.choice(len(item["margin_x"]), n, replace=False)
        fh_norm = put([item["forecast_h"] / dataset.forecast_time_period])
        tokens = model.encode(put(item["field_data"][None]), fh_norm[None, :])
        pe = encode_coord(put(item["margin_x"][sel]), put(item["margin_y"][sel]), put(item["margin_t"][sel]),
                          cfg.coord_spec)
        out = model.decode(tokens[0], pe, put(item["margin_input_data"][sel]), fh_norm)
        pred = inverse_norm_stack(out, cfg.obs_specs, with_clip=True)
        label_phys = inverse_norm_stack(put(item["margin_data"][sel]), cfg.obs_specs, with_clip=True)
        d = (pred - label_phys).cpu().numpy().astype(np.float64)  # one read a window
        sq_sum += (d**2).sum(axis=0)
        bias_sum += d.sum(axis=0)
        count += n

    rmse = np.sqrt(sq_sum / max(count, 1))
    bias = bias_sum / max(count, 1)
    out = {f"rmse_{k}": float(rmse[i]) for i, k in enumerate(VAR_NAMES)}
    out.update({f"bias_{k}": float(bias[i]) for i, k in enumerate(VAR_NAMES)})
    out["n_points"] = float(count)
    out["n_windows"] = float(n_win)
    return out


@torch.no_grad()
def _window_sums(model, cfg, window, grid: LabelGrid, device) -> torch.Tensor:
    """Per-hour sums of squared error and of error, physical units -> [n_hours, 2, 6]."""
    tokens, fh_norm, cube6 = encode_window(model, window, device)
    h, w = grid.shape
    labels = torch.as_tensor(np.asarray(window.label_cube, np.float32)).to(device)
    labels = labels.reshape(6, h * w, -1)  # [6, N, T]
    hourly = []
    for i in range(window.n_label_hours):
        t_hour = float(i * window.label_time_step)
        nwp = grid.conditioning(window, cube6, t_hour)
        out_t = collapsed_decode_t(model, tokens, grid.coords(t_hour), nwp, fh_norm, cfg.coord_spec)
        pred = inverse_norm_stack_t(out_t, cfg.obs_specs, with_clip=True)
        labp = inverse_norm_stack_t(labels[:, :, i], cfg.obs_specs, with_clip=True)
        d = (pred - labp).float()
        hourly.append(torch.stack([(d * d).sum(dim=1), d.sum(dim=1)]))
    return torch.stack(hourly)


def evaluate_rmse_fullgrid(model, cfg, windows: Sequence, max_windows: Optional[int] = None,
                           per_lead: bool = False, device=None) -> Dict[str, float]:
    """Exhaustive per-variable RMSE and bias: every label-grid point at every labelled hour.

    ``cfg`` carries ``coord_spec`` and ``obs_specs`` (a ``StepConfig`` or a
    ``DecodeConfig``); each window carries its label cube.  ``per_lead``
    also reports the RMSE per absolute forecast lead hour (the window's
    ``forecast_h`` plus the hour within it) as ``rmse_{var}_f{lead:03d}``; leads
    that several windows share aggregate across them.  The run is on ``device``:
    the first CUDA device when ``None`` (an error without one), and the model
    must already be there."""
    dev = model_device(model, device)
    sq_sum, bias_sum, count = np.zeros(6, np.float64), np.zeros(6, np.float64), 0
    lead_sq: Dict[int, np.ndarray] = {}  # absolute lead hour -> [6] squared-error sum
    lead_n: Dict[int, int] = {}
    n_win = n_windows(windows, max_windows)
    for w in range(n_win):
        window = windows[w]
        if window.label_cube is None:
            raise ValueError("evaluate_rmse_fullgrid: the window has no label cube")
        grid = LabelGrid.of(window, dev)
        n_points = grid.shape[0] * grid.shape[1]
        hourly = _window_sums(model, cfg, window, grid, dev).cpu().numpy().astype(np.float64)
        sq_sum += hourly[:, 0].sum(axis=0)
        bias_sum += hourly[:, 1].sum(axis=0)
        count += n_points * len(hourly)
        if per_lead:
            for i in range(len(hourly)):
                lead = int(round(window.forecast_h)) + i * window.label_time_step
                lead_sq[lead] = lead_sq.get(lead, 0.0) + hourly[i, 0]
                lead_n[lead] = lead_n.get(lead, 0) + n_points

    rmse = np.sqrt(sq_sum / max(count, 1))
    bias = bias_sum / max(count, 1)
    out = {f"rmse_{k}": float(rmse[i]) for i, k in enumerate(VAR_NAMES)}
    out.update({f"bias_{k}": float(bias[i]) for i, k in enumerate(VAR_NAMES)})
    for lead in sorted(lead_sq):
        r = np.sqrt(lead_sq[lead] / lead_n[lead])
        out.update({f"rmse_{k}_f{lead:03d}": float(r[i]) for i, k in enumerate(VAR_NAMES)})
    out["n_points"] = float(count)
    out["n_windows"] = float(n_win)
    out["full_grid"] = 1.0
    return out
