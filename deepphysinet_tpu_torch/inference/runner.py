"""Inference: continuous grid sweeps and point queries.

Counterpart of ``_decode_points``, ``predict_grid`` and ``predict_points`` in
``deepphysinet_tpu/inference/runner.py``.  The model is a neural field, so
the same decode answers the full output grid at any time offset and station
queries at arbitrary (lon, lat, t).  The host conditioning comes from a
``data.window.Window``; the decode runs the collapsed var-major primal path
(``physics/engine.py::collapsed_decode_t``), which goes through the Hopper
kernel on a GPU.

Differences from the JAX runner: there is no jit cache, and small queries are
not edge-padded to bucket sizes (that padding existed only to reuse XLA
compiles; each point's output is independent of the others).  Large queries
still decode in chunks of 40,960 points, which bounds the activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.device import model_device
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, NormSpec, norm_specs_from_cfg
from deepphysinet_tpu_torch.physics.engine import collapsed_decode_t
from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack_t

_VAR_KEYS = ("u", "v", "P", "T", "q", "rio")
_DECODE_CHUNK = 40960


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """The parts of the JAX ``StepConfig`` that the decode reads."""

    coord_spec: CoordSpec
    obs_specs: Tuple[NormSpec, ...]  # in OBS_NAME_ORDER
    forecast_time_period: float


def decode_config_from_cfg(config: Mapping[str, Any], pred_t_span: float = 86400.0) -> DecodeConfig:
    """Hydrate from a reference-schema ``config`` dict, as the JAX interface does
    (interface_physics.py:218-238 with ``run_inference``'s defaults)."""
    train = config["train_cfg"]
    img = train["img_size"]
    lat_size, lon_size = (int(img), int(img)) if isinstance(img, (int, float)) else map(int, img)
    specs = norm_specs_from_cfg(config["obs_norm_cfg"])
    return DecodeConfig(
        coord_spec=CoordSpec(lon_size=lon_size, lat_size=lat_size, dx=float(train.get("dx", 27000)),
                             dy=float(train.get("dy", 27000)), pred_t_span=float(pred_t_span)),
        obs_specs=tuple(specs[k] for k in OBS_NAME_ORDER),
        forecast_time_period=float(train.get("train_data", {}).get("forecast_time_period", 360)),
    )


@torch.no_grad()
def _encode(model, field: torch.Tensor, fh_norm: float) -> torch.Tensor:
    fh = torch.tensor([[fh_norm]], dtype=torch.float32, device=field.device)
    return model.encode(field.float(), fh)[0]


@torch.no_grad()
def _decode_points(model, cfg: DecodeConfig, tokens, x, y, t, nwp, fh_norm: float,
                   with_clip: bool, chunk: int = _DECODE_CHUNK) -> torch.Tensor:
    """Physical fields at arbitrary points, var-major: [6, N] on the model's device."""
    dev = tokens.device
    coords = torch.from_numpy(np.stack([np.asarray(x, np.float32), np.asarray(y, np.float32),
                                        np.asarray(t, np.float32)], axis=-1)).to(dev)
    nwp = torch.from_numpy(np.asarray(nwp, np.float32)).to(dev)
    fh = torch.tensor([fh_norm], dtype=torch.float32, device=dev)
    outs = []
    for s in range(0, coords.shape[0], chunk):
        out_t = collapsed_decode_t(model, tokens, coords[s : s + chunk], nwp[s : s + chunk], fh,
                                   cfg.coord_spec)
        outs.append(inverse_norm_stack_t(out_t, cfg.obs_specs, with_clip=with_clip))
    if not outs:
        return torch.zeros((len(cfg.obs_specs), 0), dtype=torch.float32, device=dev)
    return torch.cat(outs, dim=1)


def _place_field(model, field, device) -> torch.Tensor:
    """``field`` on the run's device; the model must already be there."""
    return torch.as_tensor(field).to(model_device(model, device))


def predict_grid(model, cfg: DecodeConfig, window, field, forecast_h: float,
                 time_id_hours: float, with_clip: bool = True,
                 out_size: Optional[tuple] = None, device=None) -> Dict[str, np.ndarray]:
    """Full output-grid sweep at one time offset -> {var: [lat, lon] physical}.

    ``field`` is the window's token matrix [1, L, enc_in] (array or tensor);
    ``out_size=(lat, lon)`` resamples the field over the same area.  The run
    is on ``device``: the first CUDA device when ``None`` (an error without
    one), and the model must already be there."""
    field = _place_field(model, field, device)
    lon_size, lat_size = cfg.coord_spec.lon_size, cfg.coord_spec.lat_size
    if out_size is None:
        out_lat_n, out_lon_n = lat_size, lon_size
        x_ax = np.arange(lon_size, dtype=np.float64)
        y_ax = np.arange(lat_size, dtype=np.float64)
    else:
        out_lat_n, out_lon_n = int(out_size[0]), int(out_size[1])
        x_ax = np.linspace(0.0, lon_size - 1.0, out_lon_n)
        y_ax = np.linspace(0.0, lat_size - 1.0, out_lat_n)
    xs, ys = np.meshgrid(x_ax, y_ax)
    x_list, y_list = xs.reshape(-1), ys.reshape(-1)
    t_list = np.full(x_list.shape, float(time_id_hours), dtype=np.float64)

    px, py, pt, nwp, _f = window.get_margin_grid(x_list, y_list, t_list)
    fh_norm = forecast_h / cfg.forecast_time_period
    tokens = _encode(model, field, fh_norm)
    phys = _decode_points(model, cfg, tokens, px, py, pt, nwp, fh_norm, with_clip).cpu().numpy()
    # row-major meshgrid flattening: the reshape is the (y, x) scatter
    return {name: phys[i].reshape(out_lat_n, out_lon_n) for i, name in enumerate(_VAR_KEYS)}


def predict_points(model, cfg: DecodeConfig, window, field, forecast_h: float,
                   lon: np.ndarray, lat: np.ndarray, t_hours: np.ndarray,
                   with_clip: bool = True, device=None) -> np.ndarray:
    """Continuous (station) queries at (lon, lat, hours into the window) -> [N, 6] physical.

    ``device`` as in ``predict_grid``."""
    field = _place_field(model, field, device)
    lon, lat, t_hours = np.asarray(lon), np.asarray(lat), np.asarray(t_hours)
    x = (lon - window.begin_lon) / window.fine_lon_step * window.dx
    y = (lat - window.begin_lat) / window.fine_lat_step * window.dy
    t = t_hours * 3600.0
    nwp = window.interp_cube_at(lon, lat, t_hours)
    fh_norm = forecast_h / cfg.forecast_time_period
    tokens = _encode(model, field, fh_norm)
    phys = _decode_points(model, cfg, tokens, x, y, t, nwp, fh_norm, with_clip)
    return phys.cpu().numpy().T
