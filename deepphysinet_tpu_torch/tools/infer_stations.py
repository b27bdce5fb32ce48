"""Station-level point inference at arbitrary continuous coordinates, the port's counterpart of
``tools/infer_stations.py``:

    python -m deepphysinet_tpu_torch.tools.infer_stations --config_file configs/X.py \\
        --stations stations.csv [--checkpoint PATH] [--out results.csv] [--device cpu] [--set ...]

``stations.csv`` columns: name,lon,lat[,t_hours] (header required; without t_hours a station is
asked at every whole hour of the window, 0 to its end).  The neural field answers off-grid positions
and fractional hours directly, through ``inference/runner.py::predict_points`` on each window
(``data/window.py::Window``); lon / lat map to the model's coordinates by the label grid's step,
which the dataset derives from its coord file.  Output: one row per (station, window, hour) with the
six surface variables in physical units.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepphysinet_tpu_torch.tools import add_common_args, build_interface


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Run the tool; returns the rows written."""
    parser = argparse.ArgumentParser("DeepPhysiNet station inference on PyTorch")
    add_common_args(parser)
    parser.add_argument("--stations", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--out", type=str, default="stations_out.csv")
    parser.add_argument("--split", type=str, default="valid_data")
    parser.add_argument("--max_windows", type=int, default=1)
    args = parser.parse_args(argv)

    from deepphysinet_tpu_torch.data.window import Window
    from deepphysinet_tpu_torch.inference.runner import predict_points

    stations = []
    with open(args.stations) as fp:
        for row in csv.DictReader(fp):
            stations.append((row["name"], float(row["lon"]), float(row["lat"]),
                             float(row["t_hours"]) if row.get("t_hours") else None))
    if not stations:
        raise SystemExit("no stations in input csv")

    interface = build_interface(args)
    model, _, _ = interface.load_physics_net(args.checkpoint)
    dataset = interface._dataset(interface.train_cfg[args.split])
    window_h = dataset.input_time_step * dataset.input_time_step_nums
    step_cfg = interface._step_cfg(float(window_h * 3600), dataset.forecast_time_period)

    rows = []
    for w in range(min(args.max_windows, len(dataset))):
        input_file = dataset.input_files[w]
        _, date_str, fh, _ = dataset._parse_item(input_file)
        window = Window.from_dataset(dataset, input_file, labels=False)
        names, lons, lats, ts = [], [], [], []  # stations x hours
        for sname, lon, lat, t in stations:
            for h in ([t] if t is not None else list(range(0, window_h + 1))):
                names.append(sname)
                lons.append(lon)
                lats.append(lat)
                ts.append(float(h))
        out = predict_points(model, step_cfg, window, window.field[None], float(fh), np.asarray(lons),
                             np.asarray(lats), np.asarray(ts), device=interface.device)
        for i in range(len(names)):
            rows.append({
                "station": names[i], "window": f"{date_str}_f{fh:03d}",
                "lon": lons[i], "lat": lats[i], "t_hours": ts[i],
                "u10": out[i, 0], "v10": out[i, 1], "psfc": out[i, 2],
                "t2": out[i, 3], "q2": out[i, 4], "rho": out[i, 5],
            })

    with open(args.out, "w", newline="") as fp:
        writer = csv.DictWriter(fp, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
