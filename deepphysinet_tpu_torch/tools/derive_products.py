"""Derived meteorological products from the NWP pressure-level cube, the port's counterpart of
``tools/derive_products.py``:

    python -m deepphysinet_tpu_torch.tools.derive_products --config_file configs/X.py \\
        [--products slp,t2,td2,u10m,v10m] [--times N] [--output DIR] [--vis] [--vs_model CKPT]
        [--device cpu] [--set ...]

For each input window the basic variables (u, v, z, T, q; w has no NWP raster and enters as zeros)
are read from the pressure-level GFS rasters the dataset indexes (``data/geotiff.py``), the products
are derived on the terrain of the constant ``elevation`` raster (``utils/products.py::ProductsUtils``)
and each is written as ``PROD_{init}_f{lead:03d}_{name}.tiff`` (and a jpg render with ``--vis``,
which needs matplotlib).  ``--vs_model CKPT`` also sweeps the trained model over the output grid of
the first window (``inference/runner.py::predict_grid``, one primal decode launch on a GPU) and
reports product-against-model statistics for the surface quantities both give.  Prints one JSON
line of what it wrote.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from deepphysinet_tpu_torch.tools import add_common_args, build_interface, require_matplotlib, vis_utils

# NWP pressure-variable raster name per basic-variable key; w has no NWP source (zeros)
_BASIC_FROM_NWP = {"u": "UU", "v": "VV", "z": "GHT", "T": "TT", "q": "QQ"}
PRESS_LEVELS_PA = (100000.0, 92500.0, 85000.0, 70000.0, 50000.0)


def products_for_window(dataset, input_file: str, products, smooth_passes=3):
    """Derive ``products`` for one indexed window; returns ``({name: [H, W]}, date_str, lead)``."""
    from deepphysinet_tpu_torch.data.geotiff import read_full_image
    from deepphysinet_tpu_torch.utils.products import ProductsUtils

    prefix, date_str, forecast_h, mode_name = dataset._parse_item(input_file)
    _read = {}  # each basic variable is decoded once per window

    def gather(var_name: str) -> np.ndarray:
        if var_name in _read:
            return _read[var_name]
        if var_name == "w":
            out = np.zeros_like(gather("z"))
        else:
            # resolved through the input map as get_item_input does ('prefix' keeps its separator)
            map_key = f"{mode_name}/{prefix}{date_str}_f{forecast_h:03d}_{_BASIC_FROM_NWP[var_name]}"
            f = os.path.join(dataset.input_path, f"{dataset.input_data_map[map_key]}.tiff")
            out = read_full_image(f, as_rgb=False, normalize=False, data_format="GDAL_FORMAT")  # [P, H, W]
        _read[var_name] = out
        return out

    elevation = read_full_image(os.path.join(dataset.constant_path, "elevation.tiff"),
                                as_rgb=False, normalize=False)[0]
    pu = ProductsUtils(gather, PRESS_LEVELS_PA[: gather("z").shape[0]], altitude=elevation,
                       smooth_passes=smooth_passes)
    return pu.forward(list(products)), date_str, forecast_h


def _to_grid(a, shape):
    """Bilinear resample of a coarse NWP-grid product onto the model's output grid (the same
    refinement relation as the dataset's trilinear NWP interpolation)."""
    a = np.asarray(a, np.float64)
    if a.shape == tuple(shape):
        return a
    ys = np.linspace(0.0, a.shape[0] - 1.0, shape[0])
    xs = np.linspace(0.0, a.shape[1] - 1.0, shape[1])
    y0 = np.clip(np.floor(ys).astype(int), 0, a.shape[0] - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, a.shape[1] - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a00 = a[np.ix_(y0, x0)]
    a01 = a[np.ix_(y0, x0 + 1)]
    a10 = a[np.ix_(y0 + 1, x0)]
    a11 = a[np.ix_(y0 + 1, x0 + 1)]
    return a00 * (1 - fy) * (1 - fx) + a01 * (1 - fy) * fx + a10 * fy * (1 - fx) + a11 * fy * fx


def products_vs_model(interface, model, dataset, input_file: str, products=("t2", "wd10m", "rh2"),
                      smooth_passes=3, precomputed=None):
    """Derived products next to the trained model's grid sweep for one window.

    The NWP pressure-level cube feeds ``ProductsUtils`` while ``predict_grid`` sweeps ``model`` (on
    the interface's device) over the output grid at the window's first hour, and the overlapping
    surface quantities are compared: product t2 against model T, product wd10m against the model's
    sqrt(u^2 + v^2) (like for like: w enters the products as zeros).  Returns ``(product_maps,
    model_maps, stats)``, the stats with RMSE and bias of each pair in physical units.
    ``precomputed`` reuses an already derived ``(prod, date_str, lead)`` of this window when it
    covers ``products``."""
    from deepphysinet_tpu_torch.data.window import Window
    from deepphysinet_tpu_torch.inference.runner import predict_grid

    if precomputed is not None and all(k in precomputed[0] for k in products):
        prod, date_str, forecast_h = precomputed
    else:
        prod, date_str, forecast_h = products_for_window(dataset, input_file, products, smooth_passes=smooth_passes)

    window_h = dataset.input_time_step * dataset.input_time_step_nums
    step_cfg = interface._step_cfg(float(window_h * 3600), dataset.forecast_time_period)
    window = Window.from_dataset(dataset, input_file, labels=False)
    grid = predict_grid(model, step_cfg, window, window.field[None], float(forecast_h), time_id_hours=0.0,
                        device=interface.device)

    stats = {}
    pairs = [("t2", prod.get("t2"), grid["T"]),
             ("wd10m", prod.get("wd10m"), np.sqrt(grid["u"] ** 2 + grid["v"] ** 2))]
    for name, a, b in pairs:
        if a is None:
            continue
        b = np.asarray(b, np.float64)
        a = _to_grid(a, b.shape)
        stats[name] = {"rmse": float(np.sqrt(np.mean((a - b) ** 2))), "bias": float(np.mean(a - b)),
                       "product_mean": float(a.mean()), "model_mean": float(b.mean())}
    return prod, grid, {"window": f"{date_str}_f{forecast_h:03d}", "pairs": stats}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the tool; returns the printed summary."""
    parser = argparse.ArgumentParser("DeepPhysiNet derived products on PyTorch")
    add_common_args(parser)
    parser.add_argument("--products", type=str, default="slp,t2,td2,u10m,v10m,rh_p850")
    parser.add_argument("--vs_model", type=str, default=None, metavar="CKPT",
                        help="checkpoint dir: also sweep the trained model over the grid and report "
                             "product-vs-model stats for the overlapping surface quantities")
    parser.add_argument("--split", type=str, default="train_data", choices=["train_data", "valid_data"])
    parser.add_argument("--times", type=int, default=None, help="only the first N indexed windows")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--vis", action="store_true", help="also render jpgs (VisUtils projection; needs matplotlib)")
    args = parser.parse_args(argv)
    if args.vis:
        require_matplotlib("--vis")

    from deepphysinet_tpu_torch.data.geotiff import save_full_image

    interface = build_interface(args)
    tc = interface.train_cfg
    dataset = interface._dataset(tc[args.split])
    out_dir = args.output or os.path.join(tc["log"].get("log_path", "."), "products")
    os.makedirs(out_dir, exist_ok=True)
    products = [p.strip() for p in args.products.split(",") if p.strip()]
    vis = vis_utils(interface, dataset) if args.vis else None

    written = []
    files = dataset.input_files[: args.times] if args.times else dataset.input_files
    first_window = None  # reused by --vs_model to skip a second derivation
    for input_file in files:
        out, date_str, forecast_h = products_for_window(dataset, input_file, products)
        if first_window is None:
            first_window = (out, date_str, forecast_h)
        for name, field in out.items():
            base = f"PROD_{date_str}_f{forecast_h:03d}_{name}"
            path = os.path.join(out_dir, base + ".tiff")
            save_full_image(path, np.asarray(field, np.float32), compression="deflate", tiled=True)
            written.append(path)
            if vis is not None:
                arr = np.asarray(field, np.float64)
                vis.forward(arr[0] if arr.ndim == 3 else arr,  # level-stacked basics: level 0
                            os.path.join(out_dir, base + ".jpg"), title=base)
    summary = {"written": len(written), "output": out_dir, "products": products}

    if args.vs_model:
        model, _, _ = interface.load_physics_net(args.vs_model)
        wanted = [p for p in ("t2", "wd10m", "rh2") if p in products] or ["t2", "wd10m"]
        prod, grid, stats = products_vs_model(interface, model, dataset, files[0], products=wanted,
                                              precomputed=first_window)
        summary["vs_model"] = stats
        if vis is not None:
            for name in wanted:
                if name in prod:
                    vis.forward(np.asarray(prod[name], np.float64),
                                os.path.join(out_dir, f"VSMODEL_prod_{name}.jpg"), title=f"product {name}")
            vis.forward(np.asarray(grid["T"], np.float64), os.path.join(out_dir, "VSMODEL_model_T.jpg"),
                        title="model T (2 m)")

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
