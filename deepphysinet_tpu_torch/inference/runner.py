"""Inference: continuous grid sweeps and point queries.

Counterpart of ``_decode_points``, ``predict_grid`` and ``predict_points`` in
``deepphysinet_tpu/inference/runner.py``.  The model is a neural field, so
the same decode answers the full output grid at any time offset and station
queries at arbitrary (lon, lat, t).  The host conditioning comes from a
``data.window.Window``; the decode runs the collapsed var-major primal path
(``physics/engine.py::collapsed_decode_t``), which goes through the Hopper
kernel on a GPU.

``run_inference`` is the JAX ``run_inference`` (:227-350) from a configuration dict: a checkpoint
(``train/checkpoint.py``: the port's, a reference ``.pth`` or a JAX pickle) and a GeoTIFF tree
(``data/dataset.py::PhysicsDataset``), one full-grid frame an hour, exported as north-up GeoTIFFs
and, where asked, jpg renders.

Differences from the JAX runner: there is no jit cache, and small queries are
not edge-padded to bucket sizes (that padding existed only to reuse XLA
compiles; each point's output is independent of the others).  Large queries
still decode in chunks of 40,960 points, which bounds the activations.  The
grid's conditioning is interpolated by ``Window.interp_cube_at`` (numpy, float64)
where the JAX runner reads it through its dataset's native kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


_DATE_FMT = "%Y-%m-%d_%H_%M_%S"
_EXPORT_KEYS = {"U": "u", "V": "v", "P": "P", "T": "T", "Q": "q", "RIO": "rio"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_inference_model(config: Mapping[str, Any], checkpoint_path: str, device=None):
    """The ``PhysicsNet`` of ``config`` with the checkpoint's weights, and the checkpoint's payload
    (its metadata: dx, dy, ``pred_t_span``, ``obs_norm_cfg`` ...).  ``train_cfg.tpu`` gives the
    compute dtype (default float32) and ``attn_impl``, as the JAX interface reads them
    (interface_physics.py:130-132)."""
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
    from deepphysinet_tpu_torch.train import checkpoint as ckpt

    payload, current_epoch, global_step = ckpt.load_checkpoint(checkpoint_path, prefix="physics")
    if payload is None:
        raise FileNotFoundError(checkpoint_path)
    print(f"resume from epoch {current_epoch} global_step {global_step}")
    tpu = dict(config["train_cfg"].get("tpu", {}))
    model = PhysicsNet(config["meta_cfg"], config["net_cfg"],
                       compute_dtype=_DTYPES[str(tpu.get("compute_dtype", "float32")).lower()],
                       device=device, attn_impl=tpu.get("attn_impl"))
    model.load_state_dict(payload["model"], strict=True)
    model.eval()
    return model, payload


def inference_setup(config: Mapping[str, Any], payload: Mapping[str, Any]):
    """The decode configuration and the open dataset of an inference run: dx, dy, ``pred_t_span``
    and ``obs_norm_cfg`` from the checkpoint (``gather_key_from_state``, defaults from the
    configuration), the dataset on ``inference_cfg.inference_data`` or ``train_cfg.valid_data``."""
    from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
    from deepphysinet_tpu_torch.train.checkpoint import gather_key_from_state

    train = config["train_cfg"]
    dx = gather_key_from_state("dx", payload, float(train.get("dx", 27000)))
    dy = gather_key_from_state("dy", payload, float(train.get("dy", 27000)))
    pred_t_span = gather_key_from_state("pred_t_span", payload, 86400.0)
    obs_norm_cfg = gather_key_from_state("obs_norm_cfg", payload, config["obs_norm_cfg"])
    run_cfg = copy.deepcopy(dict(config))
    run_cfg["train_cfg"] = dict(run_cfg["train_cfg"], dx=dx, dy=dy)
    run_cfg["obs_norm_cfg"] = obs_norm_cfg
    dcfg = decode_config_from_cfg(run_cfg, float(pred_t_span))
    data_cfg = dict(config.get("inference_cfg", {})).get("inference_data") or train.get("valid_data")
    if data_cfg is None:
        raise ValueError("inference needs inference_cfg.inference_data (dataset cfg)")
    dataset = PhysicsDataset(**data_cfg, input_variable_cfg=config["variable_cfg"], out_variable_cfg=obs_norm_cfg,
                             dx=dx, dy=dy)
    if len(dataset) == 0:
        raise RuntimeError("no input windows found for inference period")
    return dcfg, dataset


def window_covering(dataset, ref_time: datetime.datetime):
    """(input file, lead hours, hours into the window) of the first window whose
    [init + lead, + window] covers ``ref_time``; None when none does."""
    from deepphysinet_tpu_torch.data.dataset import parse_input_filename
    from deepphysinet_tpu_torch.utils import path_utils

    window_h = dataset.input_time_step * dataset.input_time_step_nums
    for input_file in dataset.input_files:
        name = path_utils.get_filename(input_file, is_suffix=False)
        _, date_str, fh, _ = parse_input_filename(name)
        t0 = datetime.datetime.strptime(date_str, "%Y-%m-%d-%H-%M-%S") + datetime.timedelta(hours=fh)
        off = (ref_time - t0).total_seconds() / 3600.0
        if 0 <= off <= window_h:
            return input_file, fh, off
    return None


def export_geotiff(path: str, img: np.ndarray, dataset, dcfg: DecodeConfig) -> None:
    """A south-up grid [lat, lon] (row 0 = begin_lat) as a north-up GeoTIFF with its geo-transform
    (JAX :331-347): pixel sizes from the respective axes, rescaled by the model-grid / output-grid
    ratio when ``img_size`` resampled the field."""
    from deepphysinet_tpu_torch.data.geotiff import save_full_image

    h, w = img.shape
    step_x = float(dataset.fine_lon_step) * (dcfg.coord_spec.lon_size - 1) / max(w - 1, 1)
    step_y = float(dataset.fine_lat_step) * (dcfg.coord_spec.lat_size - 1) / max(h - 1, 1)
    geo = (dataset.begin_lon, step_x, 0.0, dataset.begin_lat + step_y * (h - 1), 0.0, -step_y)
    save_full_image(path, img[::-1], geo_transform=geo, projection="EPSG:4326", compression="deflate", tiled=True)


def run_inference(config: Mapping[str, Any], checkpoint_path: Optional[str] = None,
                  device=None) -> List[Tuple[datetime.datetime, Dict[str, np.ndarray]]]:
    """Checkpoint-driven hourly grid inference and export: the JAX ``run_inference(interface,
    checkpoint_path=...)`` from the configuration dict ``config`` (``meta_cfg``, ``net_cfg``,
    ``train_cfg``, ``inference_cfg`` ...).

    For each ``dt`` from ``inference_cfg.start_time`` to ``end_time`` it takes the first window
    that covers the hour, builds its token matrix and NWP cube from the rasters
    (``Window.from_dataset(dataset, file, labels=False)``) and sweeps the output grid
    (``predict_grid``; ``img_size`` resamples it).  ``log.export_variable`` names the grids written:
    with ``write_source`` as ``{vis_path}/{stamp}_{var}.tiff`` (north-up), with ``with_vis`` as a jpg
    render; ``stamp`` is the hour plus ``time_offset_hours`` (default 6).  Returns
    ``[(hour, {var: [lat, lon] physical})]``.  The run is on ``device`` (``None``: the first CUDA
    device, an error without one)."""
    from deepphysinet_tpu_torch.data.window import Window
    from deepphysinet_tpu_torch.utils.vis import VisUtils

    inf_cfg = dict(config.get("inference_cfg", {}))
    img_size = inf_cfg.get("img_size")
    if img_size is None:
        out_size = None
    elif isinstance(img_size, (int, float)):
        out_size = (int(img_size), int(img_size))
    else:
        out_size = (int(img_size[0]), int(img_size[1]))
    dt = float(inf_cfg.get("dt", 3600))
    start_time = datetime.datetime.strptime(inf_cfg["start_time"], _DATE_FMT)
    end_time = datetime.datetime.strptime(inf_cfg["end_time"], _DATE_FMT)
    checkpoint_path = checkpoint_path or inf_cfg["checkpoints"]["checkpoints_path"]
    log_cfg = dict(inf_cfg.get("log", {}))
    with_vis = log_cfg.get("with_vis", False)
    vis_path = log_cfg.get("vis_path", "")
    write_source = log_cfg.get("write_source", False)
    export_variable = log_cfg.get("export_variable", ["T"])
    time_offset_h = float(log_cfg.get("time_offset_hours", 6))  # the reference exports at ref_time + 6 h (:1520)

    model, payload = load_inference_model(config, checkpoint_path, device)
    dcfg, dataset = inference_setup(config, payload)
    vis_cfg = dict(log_cfg.get("vis_downscale_cfg", {}))
    vis_cfg.setdefault("landsea_file", os.path.join(dataset.constant_path, "landsea.tiff"))
    vis_utils = VisUtils(**vis_cfg) if with_vis else None
    if (with_vis or write_source) and vis_path:
        os.makedirs(vis_path, exist_ok=True)  # the GeoTIFF writer does not create directories

    results = []
    ref_time = start_time
    while ref_time <= end_time:
        chosen = window_covering(dataset, ref_time)
        if chosen is None:
            ref_time += datetime.timedelta(seconds=dt)
            continue
        input_file, fh, off = chosen
        window = Window.from_dataset(dataset, input_file, labels=False)
        grids = predict_grid(model, dcfg, window, window.field[None], float(fh), off, with_clip=True,
                             out_size=out_size, device=device)
        stamp = (ref_time + datetime.timedelta(hours=time_offset_h)).strftime(_DATE_FMT)
        for variable_name in export_variable:
            img = grids[_EXPORT_KEYS[variable_name.upper()]]
            if with_vis and vis_utils is not None:
                vis_utils.forward(img, os.path.join(vis_path, f"{stamp}_{variable_name}_vis.jpg"))
            if write_source:
                export_geotiff(os.path.join(vis_path, f"{stamp}_{variable_name}.tiff"), img, dataset, dcfg)
        results.append((ref_time, grids))
        ref_time += datetime.timedelta(seconds=dt)
    return results
