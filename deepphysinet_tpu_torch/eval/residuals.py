"""Physics-consistency diagnostics: PDE residual magnitudes of a model.

Counterpart of ``deepphysinet_tpu/eval/residuals.py``, over a sequence of
``data.window.Window`` where the JAX functions take a ``PhysicsDataset``:

* ``evaluate_residuals``: per-equation mean-squared residuals (raw physical
  units and weighted by the training loss factors) over the full label grid at
  every labelled hour.  Per window: one encode, a Python loop over the hours (a
  ``lax.scan`` in JAX) through ``engine.fused_residual_losses`` (the var-major
  v4t forward kernel on a GPU, then the packed assembly), sums kept on the
  device, one device-to-host read;
* ``residual_field_maps``: per-point squared-residual fields [H, W] of one
  window and hour, through ``engine.fused_kernel_fields`` (the ``[N, 6]`` v4
  forward kernel on a GPU) and the equations of ``physics/equations.py``.

The JAX functions' ``use_kernel`` is not carried: the wrappers launch their
kernels on CUDA tensors and run their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deepphysinet_tpu_torch.device import model_device
from deepphysinet_tpu_torch.eval.common import LabelGrid, encode_window, n_windows
from deepphysinet_tpu_torch.ops.coords import coriolis
from deepphysinet_tpu_torch.physics import equations as eqs
from deepphysinet_tpu_torch.physics.engine import fused_kernel_fields, fused_residual_losses

EQ_NAMES = ("momentum_u", "momentum_v", "continuity", "energy", "vapor", "gas")
_LOSS_KEYS = ("montion_u_loss", "montion_v_loss", "continous_loss",
              "energy_loss", "vapor_loss", "gas_loss")
_FACTOR_KEYS = ("motion_u_factor", "motion_v_factor", "continuous_factor",
                "energy_factor", "vapor_factor", "gas_factor")
_UNIT_FACTORS = {k: 1.0 for k in _FACTOR_KEYS}


@torch.no_grad()
def _window_mses(model, cfg, window, grid: LabelGrid, device) -> torch.Tensor:
    """Raw per-equation MSE [6] over the window's labelled hours (unit loss factors)."""
    tokens, fh_norm, cube6 = encode_window(model, window, device)
    f = coriolis(grid.lat)  # [N, 1]
    acc = torch.zeros(6, dtype=torch.float32, device=device)
    n_hours = window.n_label_hours
    for i in range(n_hours):
        t_hour = float(i * window.label_time_step)
        nwp = grid.conditioning(window, cube6, t_hour)
        losses = fused_residual_losses(model, tokens, grid.coords(t_hour), nwp, fh_norm, f,
                                       cfg.coord_spec, cfg.obs_specs, _UNIT_FACTORS,
                                       with_clip=True)
        acc = acc + torch.stack([losses[k] for k in _LOSS_KEYS])
    return acc / n_hours


def evaluate_residuals(model, cfg, windows: Sequence, max_windows: Optional[int] = None,
                       device=None) -> Dict[str, float]:
    """Mean per-equation squared residuals over held-out windows.

    Returns ``residual_mse_<eq>`` (raw physical-unit MSE), ``weighted_<eq>``
    (scaled by the training loss factors of ``cfg``, a ``StepConfig``) and
    ``weighted_total``.  The run is on ``device``: the first CUDA device when
    ``None`` (an error without one), and the model must already be there."""
    dev = model_device(model, device)
    sums = np.zeros(6, np.float64)
    n_win = n_windows(windows, max_windows)
    first = windows[0] if len(windows) else None  # a DatasetWindows reads its rasters at each access
    for w in range(n_win):
        window = first if w == 0 else windows[w]
        grid = LabelGrid.of(window, dev)
        sums += _window_mses(model, cfg, window, grid, dev).cpu().numpy().astype(np.float64)
    mean = sums / max(n_win, 1)

    out = {f"residual_mse_{k}": float(mean[i]) for i, k in enumerate(EQ_NAMES)}
    weighted_total = 0.0
    for i, (k, fk) in enumerate(zip(EQ_NAMES, _FACTOR_KEYS)):
        wv = float(mean[i]) * float(cfg.loss_factor[fk])
        out[f"weighted_{k}"] = wv
        weighted_total += wv
    out["weighted_total"] = weighted_total
    if first is not None:  # what the JAX function reads off its dataset
        out["n_points_per_hour"] = float(len(first.out_lat) * len(first.out_lon))
        out["n_hours"] = float(first.n_label_hours)
    out["n_windows"] = float(n_win)
    return out


@torch.no_grad()
def residual_field_maps(model, cfg, windows: Sequence, window: int = 0, hour: int = 0,
                        device=None) -> Dict[str, np.ndarray]:
    """Squared-residual field [H, W] per equation at one window and hour.

    The per-point differences are the output, so this goes through the fields
    form of the decode (``fused_kernel_fields``), not the summed residual losses."""
    dev = model_device(model, device)
    win = windows[window]
    grid = LabelGrid.of(win, dev)
    tokens, fh_norm, cube6 = encode_window(model, win, dev)
    nwp = grid.conditioning(win, cube6, float(hour))
    _, fd = fused_kernel_fields(model, tokens, grid.coords(float(hour)), nwp, fh_norm,
                                cfg.coord_spec, cfg.obs_specs, with_clip=True)
    f = coriolis(grid.lat)
    pairs = (
        eqs.momentum_u_residual(fd.fields, fd.derivs, f),
        eqs.momentum_v_residual(fd.fields, fd.derivs, f),
        eqs.continuity_residual(fd.fields, fd.derivs),
        eqs.energy_residual(fd.fields, fd.derivs),
        eqs.vapor_residual(fd.fields, fd.derivs),
        eqs.gas_residual(fd.fields),
    )
    stacked = torch.stack([torch.square(d - c)[:, 0].reshape(grid.shape) for d, c in pairs])
    stacked = stacked.cpu().numpy()
    return {k: stacked[i] for i, k in enumerate(EQ_NAMES)}
