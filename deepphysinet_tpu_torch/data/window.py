"""One input window held in memory: the host side of inference and of the evaluation sweeps.

A stand-in for the ``PhysicsDataset`` methods that ``inference/runner.py`` and
``eval/`` call (``deepphysinet_tpu/data/dataset.py``): the window's token matrix
(``get_item_input`` rows plus ``constant_variables``), its normalized NWP cube
(``_nwp_cube``), trilinear interpolation of that cube at scattered points
(``_interp_cube_at``, here with the numpy ``_np_trilinear`` of
dataset.py:101-115), the full-grid conditioning (``get_margin_grid``), the
Coriolis parameter, the grid axes and dx/dy, and for the evaluation sweeps the
normalized label cube (``get_label_cube``) with the time steps that define the
window's labelled hours.  A window comes from a GeoTIFF tree through the
port's ``data/dataset.py::PhysicsDataset`` (``Window.from_dataset``), or from
``synthetic_window``.  ``synthetic_batch`` draws
one training batch (margin and collocation points with their conditioning,
Coriolis parameter and labels) at the configuration's sizes; sampling points
from real windows on the device is not ported yet.
"""

from __future__ import annotations

import collections.abc
import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from deepphysinet_tpu_torch.ops.coords import OMEGA, make_latlon_grid

# The repo's study grids: 0.25-degree labels, 1-degree NWP inputs, both
# anchored at (72E, 18N) (configs/DeepPhysiNet_NCEP_cfg.py, data/synthetic.py).
FINE_STEP_DEG = 0.25
COARSE_FACTOR = 4
ORIGIN_LON, ORIGIN_LAT = 72.0, 18.0


def _np_trilinear(cube: np.ndarray, lat, lon, th, lat_p, lon_p, t_p) -> np.ndarray:
    """Linear interp of cube [H, W, T] at scattered points (uniform grids)."""
    fy = np.clip((lat_p - lat[0]) / (lat[1] - lat[0]), 0, len(lat) - 1)
    fx = np.clip((lon_p - lon[0]) / (lon[1] - lon[0]), 0, len(lon) - 1)
    ft = np.clip((t_p - th[0]) / (th[1] - th[0]), 0, len(th) - 1)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, len(lat) - 2)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, len(lon) - 2)
    t0 = np.clip(np.floor(ft).astype(np.int64), 0, len(th) - 2)
    wy, wx, wt = fy - y0, fx - x0, ft - t0
    out = np.zeros(len(lat_p), np.float64)
    for dy_, wy_ in ((0, 1 - wy), (1, wy)):
        for dx_, wx_ in ((0, 1 - wx), (1, wx)):
            for dt_, wt_ in ((0, 1 - wt), (1, wt)):
                out += wy_ * wx_ * wt_ * cube[y0 + dy_, x0 + dx_, t0 + dt_]
    return out


@dataclasses.dataclass
class Window:
    field: np.ndarray  # [token_num, enc_in] normalized tokens, constant rows last
    nwp_cube: np.ndarray  # [6, H, W, T] normalized obs-variable NWP cube
    forecast_h: float  # lead of the window's first step, hours
    in_lon: np.ndarray  # coarse (NWP) axes, degrees
    in_lat: np.ndarray
    out_lon: np.ndarray  # fine (output) axes, degrees
    out_lat: np.ndarray
    dx: float  # meters per fine grid step
    dy: float
    input_time_step: int = 6  # hours between the cube's time levels
    input_time_step_nums: int = 4  # time levels after the first: the window spans their product
    label_time_step: int = 1  # hours between the label cube's time levels
    forecast_time_period: float = 360.0  # hours that normalize the forecast lead
    label_cube: Optional[np.ndarray] = None  # [6, lat, lon, T] normalized labels on the fine grid

    @property
    def n_label_hours(self) -> int:
        """Labelled hours of the window: every ``label_time_step`` from 0 to its end."""
        return self.input_time_step * self.input_time_step_nums // self.label_time_step + 1

    @property
    def begin_lon(self) -> float:
        return float(self.out_lon[0])

    @property
    def begin_lat(self) -> float:
        return float(self.out_lat[0])

    @property
    def fine_lon_step(self) -> float:
        return float(self.out_lon[1] - self.out_lon[0])

    @property
    def fine_lat_step(self) -> float:
        return float(self.out_lat[1] - self.out_lat[0])

    def interp_cube_at(self, lon_p, lat_p, t_p) -> np.ndarray:
        """The NWP cube at scattered (lon, lat, t-hours) points -> [N, 6] float32."""
        lon_p, lat_p, t_p = (np.asarray(a, np.float64) for a in (lon_p, lat_p, t_p))
        th = np.arange(self.nwp_cube.shape[-1]) * self.input_time_step
        cols = [_np_trilinear(self.nwp_cube[v], self.in_lat, self.in_lon, th, lat_p, lon_p, t_p)
                for v in range(self.nwp_cube.shape[0])]
        return np.stack(cols, axis=-1).astype(np.float32)

    def get_coriolis(self, lat) -> np.ndarray:
        f = 2 * OMEGA * np.sin(np.asarray(lat) / 180.0 * np.pi)
        return f[:, None] if f.ndim == 1 else f

    def get_margin_grid(self, x_list, y_list, t_list):
        """Physical coords, conditioning [N, 6] and Coriolis at fine-grid indices."""
        lon = self.begin_lon + np.asarray(x_list) * self.fine_lon_step
        lat = self.begin_lat + np.asarray(y_list) * self.fine_lat_step
        data = self.interp_cube_at(lon, lat, np.asarray(t_list))
        return (
            (np.asarray(x_list) * self.dx).astype(np.float32),
            (np.asarray(y_list) * self.dy).astype(np.float32),
            (np.asarray(t_list) * 3600.0).astype(np.float32),
            data,
            self.get_coriolis(lat).astype(np.float32),
        )

    @classmethod
    def from_dataset(cls, dataset: Any, input_file: str, labels: bool = True) -> "Window":
        """Copy one window's arrays out of a ``PhysicsDataset`` (``data/dataset.py``, or an object
        with its methods); the label cube too unless ``labels`` is off (a dataset without label
        files)."""
        field = np.concatenate([dataset.get_item_input(input_file),
                                dataset.constant_variables], axis=0)
        _, _, forecast_h, _ = dataset._parse_item(input_file)
        return cls(field=field, nwp_cube=dataset._nwp_cube(input_file),
                   forecast_h=float(forecast_h),
                   in_lon=np.asarray(dataset.in_lon), in_lat=np.asarray(dataset.in_lat),
                   out_lon=np.asarray(dataset.out_lon), out_lat=np.asarray(dataset.out_lat),
                   dx=float(dataset.dx), dy=float(dataset.dy),
                   input_time_step=int(dataset.input_time_step),
                   input_time_step_nums=int(dataset.input_time_step_nums),
                   label_time_step=int(dataset.label_time_step),
                   forecast_time_period=float(dataset.forecast_time_period),
                   label_cube=dataset.get_label_cube(input_file) if labels else None)


class DatasetWindows(collections.abc.Sequence):
    """The windows of a ``PhysicsDataset`` in its order, each read from the rasters when it is
    taken (``Window.from_dataset``, with its label cube): the sequence that the evaluation sweeps
    take, without holding every window in memory."""

    def __init__(self, dataset: Any):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset.input_files)

    def __getitem__(self, i: int) -> Window:
        return Window.from_dataset(self.dataset, self.dataset.input_files[i])


def _grid_shapes(config: Mapping[str, Any]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    img = config["train_cfg"]["img_size"]
    lat_n, lon_n = (int(img), int(img)) if isinstance(img, (int, float)) else map(int, img)
    return (lat_n, lon_n), ((lat_n - 1) // COARSE_FACTOR + 1, (lon_n - 1) // COARSE_FACTOR + 1)


def synthetic_window(config: Mapping[str, Any], seed: int) -> Window:
    """A seeded window at the configuration's sizes, made with numpy.

    ``config`` is the reference-schema ``config`` dict (``meta_cfg``,
    ``net_cfg``, ``train_cfg``, ...).  The flagship gives field [159, 2405]
    (155 normalized NWP rows + 4 min-max constant rows in [0, 1)), an NWP
    cube [6, 37, 65, 5] and a label cube [6, 145, 257, 25]."""
    (lat_n, lon_n), (clat, clon) = _grid_shapes(config)
    enc_in = int(config["meta_cfg"]["enc_in"])
    if clat * clon != enc_in:
        raise ValueError(f"coarse grid {clat}x{clon} does not match enc_in {enc_in}")
    train = config["train_cfg"]
    data_cfg = train["train_data"]
    n_const = len(data_cfg.get("constant_variables", ("landsea", "elevation")))
    token_num = int(config["net_cfg"]["token_num"])
    step_nums = int(data_cfg.get("input_time_step_nums", 4))
    n_times = step_nums + 1
    input_time_step = int(data_cfg.get("input_time_step", 6))
    label_time_step = int(data_cfg.get("label_time_step", 1))

    rng = np.random.RandomState(seed)
    field = np.concatenate([
        rng.standard_normal((token_num - n_const, enc_in)),
        rng.random_sample((n_const, enc_in)),
    ]).astype(np.float32)
    cube = (0.5 * rng.standard_normal((6, clat, clon, n_times))).astype(np.float32)
    in_lon, in_lat = make_latlon_grid(
        ORIGIN_LON, ORIGIN_LAT, ORIGIN_LON + (clon - 1) * FINE_STEP_DEG * COARSE_FACTOR,
        ORIGIN_LAT + (clat - 1) * FINE_STEP_DEG * COARSE_FACTOR, FINE_STEP_DEG * COARSE_FACTOR)
    out_lon, out_lat = make_latlon_grid(
        ORIGIN_LON, ORIGIN_LAT, ORIGIN_LON + (lon_n - 1) * FINE_STEP_DEG,
        ORIGIN_LAT + (lat_n - 1) * FINE_STEP_DEG, FINE_STEP_DEG)
    # drawn last, so that the field and the NWP cube of a seed stay what they were
    label_cube = (0.5 * rng.standard_normal(
        (6, lat_n, lon_n, input_time_step * step_nums // label_time_step + 1))).astype(np.float32)
    return Window(field=field, nwp_cube=cube, forecast_h=24.0,
                  in_lon=in_lon[0], in_lat=in_lat[:, 0], out_lon=out_lon[0], out_lat=out_lat[:, 0],
                  dx=float(train["dx"]), dy=float(train["dy"]),
                  input_time_step=input_time_step, input_time_step_nums=step_nums,
                  label_time_step=label_time_step,
                  forecast_time_period=float(data_cfg.get("forecast_time_period", 360)),
                  label_cube=label_cube)


def synthetic_batch(config: Mapping[str, Any], seed: int) -> Dict[str, Any]:
    """A seeded training batch of one window at the configuration's sizes, as nested numpy arrays.

    The draws of the JAX package's ``bench.py`` (:73-93): points uniform over
    the output grid in meters, times on whole hours of the 24 h window,
    Coriolis ``1e-4 * U[0, 1)``, conditioning values and labels ``0.1 * N(0, 1)``,
    token matrix ``0.5 * N(0, 1)``, lead 24 h.  The flagship gives 20,480 margin
    and 4,096 collocation points per window.  ``train.train_step.
    batch_to_device`` turns the result into a ``Batch`` of tensors."""
    (lat_n, lon_n), _ = _grid_shapes(config)
    train = config["train_cfg"]
    data_cfg = train["train_data"]
    dx, dy = float(train["dx"]), float(train["dy"])
    rng = np.random.RandomState(seed)
    b = 1  # windows in the batch

    def points(n: int) -> Dict[str, np.ndarray]:
        return dict(
            x=(rng.rand(b, n) * dx * (lon_n - 1)).astype(np.float32),
            y=(rng.rand(b, n) * dy * (lat_n - 1)).astype(np.float32),
            t=(rng.randint(0, 25, (b, n)) * 3600.0).astype(np.float32),
            f=(1e-4 * rng.rand(b, n, 1)).astype(np.float32),
            nwp=(rng.randn(b, n, 6) * 0.1).astype(np.float32),
            labels=(rng.randn(b, n, 6) * 0.1).astype(np.float32),
        )

    margin = points(int(data_cfg["label_batch_size"]))
    inter = points(int(data_cfg["batch_size_inter"]))
    field = (rng.randn(b, int(config["net_cfg"]["token_num"]), int(config["meta_cfg"]["enc_in"]))
             * 0.5).astype(np.float32)
    return dict(field=field, forecast_h=np.full(b, 24.0, np.float32), margin=margin, inter=inter)
