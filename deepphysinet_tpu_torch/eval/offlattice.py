"""Off-lattice generalization evaluation on synthetic trees.

Counterpart of ``deepphysinet_tpu/eval/offlattice.py``.  The product's headline claim is
continuous downscaling: the hypernet MLP answers at any coordinate and time, not only on the label
lattice.  A synthetic tree's truth (``data/synthetic.py::_field``) is a closed-form function of
(lon, lat, hours), so it can be scored anywhere.

``evaluate_offlattice`` draws paired query sets per window:

* on-lattice: integer fine-grid points at labelled whole hours (the training distribution);
* off-lattice: the same draws shifted by half a fine-grid cell in lon and lat and half a label
  time step, as far from every training label as the lattice allows.

Both sets are conditioned by the device interpolator (``ops/interp.py::trilinear_interp_cube``),
decoded by ``physics/engine.py::collapsed_decode`` (the primal kernel on a GPU) and compared in
physical units with the closed-form truth.  A model that only interpolates its label lattice shows
off/on RMSE ratios far above 1; one that learned the field shows ratios near 1.

The draws come from ``np.random.RandomState(seed)`` in the JAX function's order (the hour slots of
a window, then ``xs`` and ``ys`` for each slot), so the two packages score the same points.  The
port encodes a window once where the JAX function encodes at each decode call (the same tokens),
and reads each window's outputs to the host in one copy, as JAX's one ``device_get``.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import numpy as np
import torch

from deepphysinet_tpu_torch.device import model_device
from deepphysinet_tpu_torch.ops.interp import trilinear_interp_cube
from deepphysinet_tpu_torch.physics.engine import collapsed_decode
from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack

# decode output column order (u, v, P, T, q, rho) -> synthetic field names
SYNTH_NAMES = ("u10", "v10", "PSFC", "t2", "q2", "rio")
# metric keys, matching eval/rmse.py::VAR_NAMES
VAR_NAMES = ("u10", "v10", "pres", "t2", "q2", "rio")

_DATE_FMT = "%Y-%m-%d-%H-%M-%S"


def _truth_at(lon: np.ndarray, lat: np.ndarray, abs_hours: float, synth_seed: int) -> np.ndarray:
    """Closed-form synthetic truth [N, 6] (physical units) at one instant."""
    from deepphysinet_tpu_torch.data.synthetic import _field

    cols = [_field(name, lon[:, None], lat[:, None], abs_hours, 1, synth_seed)[:, 0, 0]
            for name in SYNTH_NAMES]
    return np.stack(cols, axis=-1)


@torch.no_grad()
def evaluate_offlattice(model, cfg, dataset, n_points: int = 16384, times_per_window: int = 4,
                        max_windows: Optional[int] = None, seed: int = 0,
                        synth_start: str = "2008-01-01_00_00_00", synth_seed: int = 0,
                        device=None) -> Dict[str, float]:
    """Paired on-lattice / off-lattice RMSE against the closed-form truth.

    Only meaningful on synthetic trees: ``synth_start`` and ``synth_seed`` must match the generator
    call that wrote ``dataset``'s files (the defaults are ``generate_synthetic_dataset``'s).
    ``cfg`` carries ``coord_spec`` and ``obs_specs`` (a ``StepConfig`` or a ``DecodeConfig``).
    Returns ``rmse_<var>`` (off-lattice), ``rmse_<var>_ongrid`` (paired on-lattice),
    ``ratio_<var>`` = off/on and ``n_points``.  The run is on ``device``: the first CUDA device when
    ``None`` (an error without one), and the model must already be there."""
    dev = model_device(model, device)
    H, W = dataset.label_lat_size, dataset.label_lon_size
    fine_lon = float(dataset.out_lon[1] - dataset.out_lon[0])
    fine_lat = float(dataset.out_lat[1] - dataset.out_lat[0])
    grid = dict(lon0=float(dataset.in_lon[0]), dlon=float(dataset.in_lon[1] - dataset.in_lon[0]),
                lat0=float(dataset.in_lat[0]), dlat=float(dataset.in_lat[1] - dataset.in_lat[0]),
                t0=0.0, dt=float(dataset.input_time_step))
    lts = int(dataset.label_time_step)
    window_h = dataset.input_time_step * dataset.input_time_step_nums
    start_dt = datetime.datetime.strptime(synth_start, "%Y-%m-%d_%H_%M_%S")

    times_per_window = max(1, min(times_per_window, window_h // lts))
    n_per_t = max(1, n_points // times_per_window)
    rng = np.random.RandomState(seed)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    sq = {"on": np.zeros(6, np.float64), "off": np.zeros(6, np.float64)}
    counts = {"on": 0, "off": 0}
    n_windows = len(dataset) if max_windows is None else min(max_windows, len(dataset))
    for w in range(n_windows):
        input_file = dataset.input_files[w]
        field = put(np.concatenate([dataset.get_item_input(input_file), dataset.constant_variables], axis=0)[None])
        _, date_str, forecast_h, _ = dataset._parse_item(input_file)
        init = datetime.datetime.strptime(date_str, _DATE_FMT)
        base_hours = (init - start_dt).total_seconds() / 3600.0 + float(forecast_h)
        fh_norm = put([forecast_h / dataset.forecast_time_period])
        tokens = model.encode(field, fh_norm[None, :])[0]
        cube6 = put(dataset._nwp_cube(input_file))

        # labelled whole hours with room for the +0.5 * lts shift
        hour_slots = rng.choice(max(window_h // lts, 1), size=times_per_window, replace=False)
        jobs, outs = [], []  # (kind, lon, lat, t_h) beside each decode's [n_per_t, 6] output
        for slot in hour_slots:
            # integer lattice draws, away from the +x / +y edges so that the paired half-cell shift
            # stays inside the domain
            xs = rng.randint(0, W - 1, n_per_t).astype(np.float64)
            ys = rng.randint(0, H - 1, n_per_t).astype(np.float64)
            t0 = float(slot * lts)
            for kind, fx, fy, ft in (("on", 0.0, 0.0, 0.0), ("off", 0.5, 0.5, 0.5 * lts)):
                xq, yq = xs + fx, ys + fy
                t_h = t0 + ft
                lon = dataset.begin_lon + xq * fine_lon
                lat = dataset.begin_lat + yq * fine_lat
                lon_d, lat_d = put(lon), put(lat)
                nwp = trilinear_interp_cube(cube6, lon_d, lat_d, put(np.full(n_per_t, t_h)), **grid).t()
                coords = torch.stack([put(xq * dataset.dx), put(yq * dataset.dy),
                                      put(np.full(n_per_t, t_h * 3600.0))], dim=-1)
                out = collapsed_decode(model, tokens, coords, nwp, fh_norm, cfg.coord_spec)
                outs.append(inverse_norm_stack(out, cfg.obs_specs, with_clip=True))
                jobs.append((kind, lon, lat, t_h))
        fetched = torch.stack(outs).cpu().numpy()  # one device-to-host read for the window
        for (kind, lon, lat, t_h), pred in zip(jobs, fetched):
            truth = _truth_at(lon, lat, base_hours + t_h, synth_seed)
            d = np.asarray(pred, np.float64) - truth
            sq[kind] += (d * d).sum(axis=0)
            counts[kind] += n_per_t

    out: Dict[str, float] = {}
    r_on = np.sqrt(sq["on"] / max(counts["on"], 1))
    r_off = np.sqrt(sq["off"] / max(counts["off"], 1))
    for i, k in enumerate(VAR_NAMES):
        out[f"rmse_{k}"] = float(r_off[i])
        out[f"rmse_{k}_ongrid"] = float(r_on[i])
        out[f"ratio_{k}"] = float(r_off[i] / max(r_on[i], 1e-30))
    out["n_points"] = float(counts["off"])
    return out
