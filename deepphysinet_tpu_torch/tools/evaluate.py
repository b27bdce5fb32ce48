"""Held-out RMSE of a trained checkpoint, the port's counterpart of ``tools/evaluate.py``:

    python -m deepphysinet_tpu_torch.tools.evaluate --config_file configs/X.py [--checkpoint PATH]
        [--max_windows N] [--split valid_data] [--full_grid [--per_lead] | --off_lattice
        | --residuals [--save_maps DIR]] [--device cpu] [--set key.path=value ...]

Prints one JSON line of per-variable RMSE and bias in physical units (or the mode's metrics), with
the checkpoint's ``epoch`` and ``global_step``.  The modes and their sweeps:

* default: the subsampled estimate, ``eval/rmse.py::evaluate_rmse`` (``--points_per_window``);
* ``--full_grid``: every labelled grid point at every labelled hour, ``evaluate_rmse_fullgrid`` over
  ``data/window.py::DatasetWindows`` (``--per_lead``: also per forecast lead hour);
* ``--off_lattice``: synthetic trees only, paired on / off-lattice RMSE against the closed-form
  truth, ``eval/offlattice.py::evaluate_offlattice`` (``--synth_start``, ``--synth_seed``);
* ``--residuals``: per-equation PDE residual MSEs, ``eval/residuals.py::evaluate_residuals``;
  ``--save_maps DIR`` also renders one window's and hour's squared-residual maps (log10) as jpgs
  (``--map_window``, ``--map_hour``; needs matplotlib).

The checkpoint is the port's ``.pth``, a reference ``.pth`` or a JAX pickle
(``train/checkpoint.py::load_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

from deepphysinet_tpu_torch.tools import add_common_args, build_interface, require_matplotlib, vis_utils


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the tool; returns the printed metrics."""
    parser = argparse.ArgumentParser("DeepPhysiNet evaluation on PyTorch")
    add_common_args(parser)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--max_windows", type=int, default=None)
    parser.add_argument("--split", type=str, default="valid_data", choices=["train_data", "valid_data"])
    parser.add_argument("--points_per_window", type=int, default=20480)
    parser.add_argument("--full_grid", action="store_true",
                        help="exhaustive sweep: every labeled grid point at every labeled hour (headline RMSE mode)")
    parser.add_argument("--per_lead", action="store_true",
                        help="with --full_grid: also report RMSE per absolute forecast lead hour "
                             "(rmse_<var>_f<lead> keys -- the skill-vs-lead verification curve)")
    parser.add_argument("--off_lattice", action="store_true",
                        help="synthetic trees only: paired on/off-lattice RMSE vs the closed-form truth "
                             "(half-cell / half-step offsets) -- the continuous-downscaling generalization check")
    parser.add_argument("--synth_start", type=str, default="2008-01-01_00_00_00")
    parser.add_argument("--synth_seed", type=int, default=0)
    parser.add_argument("--residuals", action="store_true",
                        help="physics-consistency mode: per-equation PDE residual MSEs over the full label grid "
                             "instead of RMSE vs labels")
    parser.add_argument("--save_maps", type=str, default=None, metavar="DIR",
                        help="with --residuals: also render per-equation squared-residual maps (log10) for one "
                             "window/hour as jpgs into DIR")
    parser.add_argument("--map_window", type=int, default=0)
    parser.add_argument("--map_hour", type=int, default=0)
    args = parser.parse_args(argv)
    if args.residuals and args.save_maps:
        require_matplotlib("--save_maps")

    from deepphysinet_tpu_torch.data.window import DatasetWindows
    from deepphysinet_tpu_torch.eval import rmse

    interface = build_interface(args)
    model, epoch, step = interface.load_physics_net(args.checkpoint)
    dataset = interface._dataset(interface.train_cfg[args.split])
    window_h = dataset.input_time_step * dataset.input_time_step_nums
    step_cfg = interface._step_cfg(float(window_h * 3600), dataset.forecast_time_period)
    dev = interface.device

    if args.off_lattice:
        from deepphysinet_tpu_torch.eval.offlattice import evaluate_offlattice

        metrics = evaluate_offlattice(model, step_cfg, dataset, max_windows=args.max_windows,
                                      n_points=args.points_per_window, synth_start=args.synth_start,
                                      synth_seed=args.synth_seed, device=dev)
    elif args.residuals:
        from deepphysinet_tpu_torch.eval.residuals import evaluate_residuals, residual_field_maps

        windows = DatasetWindows(dataset)
        metrics = evaluate_residuals(model, step_cfg, windows, max_windows=args.max_windows, device=dev)
        if args.save_maps:
            import numpy as np

            maps = residual_field_maps(model, step_cfg, windows, window=args.map_window, hour=args.map_hour,
                                       device=dev)
            vis = vis_utils(interface, dataset)
            for eq, m in maps.items():
                # squared residuals span many decades -> log10 render
                vis.forward(np.log10(m + 1e-30), os.path.join(args.save_maps, f"residual_{eq}.jpg"),
                            title=f"log10 squared {eq} residual (w{args.map_window} h{args.map_hour})")
            metrics["maps_dir"] = os.path.abspath(args.save_maps)
    elif args.full_grid:
        metrics = rmse.evaluate_rmse_fullgrid(model, step_cfg, DatasetWindows(dataset), max_windows=args.max_windows,
                                              per_lead=args.per_lead, device=dev)
    else:
        metrics = rmse.evaluate_rmse(model, step_cfg, dataset, max_windows=args.max_windows,
                                     points_per_window=args.points_per_window, device=dev)
    metrics["epoch"] = epoch - 1
    metrics["global_step"] = step
    print(json.dumps({k: round(v, 6) if isinstance(v, float) else v for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
