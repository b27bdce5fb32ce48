"""The port's command-line tools, counterparts of the repository's ``tools/evaluate.py``,
``tools/infer_stations.py`` and ``tools/derive_products.py``:

    python -m deepphysinet_tpu_torch.tools.evaluate --config_file configs/X.py [...]
    python -m deepphysinet_tpu_torch.tools.infer_stations --config_file configs/X.py --stations s.csv
    python -m deepphysinet_tpu_torch.tools.derive_products --config_file configs/X.py [--vs_model CKPT]

Each takes the JAX tool's flags, and ``--device`` (default: the first CUDA device) and ``--set
key.path=value`` as the port's command line (``cli.py``) does.  Each ``main(argv)`` returns what
it printed or wrote, so that a caller can run it in process.

The ETL tools, counterparts of ``tools/cvt_grib_to_nc.py``, ``extract_variable_from_nc.py``,
``extract_variable_from_ERA5.py``, ``calc_rio.py``, ``calc_mean_std.py`` and
``generate_input_map.py``, turn raw GRIB2 and NetCDF archives into the GeoTIFF tree that the
trainer reads, in this order (README, "Data preparation"):

    python -m deepphysinet_tpu_torch.tools.cvt_grib_to_nc --data_path GRIB --result_path NC [--pressure]
    python -m deepphysinet_tpu_torch.tools.extract_variable_from_nc --data_path NC --result_path TREE/input/NCEP [--pressure]
    python -m deepphysinet_tpu_torch.tools.extract_variable_from_ERA5 --data_path ERA5 --result_path TREE/labels
    python -m deepphysinet_tpu_torch.tools.calc_rio --data_path TREE/input/NCEP  (and TREE/labels)
    python -m deepphysinet_tpu_torch.tools.calc_mean_std --data_path TREE/input/NCEP --result_path STATS
    python -m deepphysinet_tpu_torch.tools.generate_input_map --data_path TREE/input/NCEP --result_file MAP

They take the JAX tools' flags, need numpy only (the codecs are ``data/grib2.py``,
``data/netcdf_classic.py`` and ``data/hdf5_lite.py``; netCDF4, and xarray with cfgrib, are used
where installed, as the JAX tools use them), and run their ``--num_threads`` workers through
``run_workers``, which raises a worker's exception in the caller.
"""

from __future__ import annotations

import importlib.util


def add_common_args(parser) -> None:
    """The flags every tool shares: ``--config_file``, ``--device`` and ``--set``."""
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cpu; default the first CUDA device")
    parser.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                        help="dotted config override applied to config.*, as the port's command line takes it")


def build_interface(args):
    """The interface of ``args.config_file`` with the ``--set`` overrides, on ``args.device``."""
    from deepphysinet_tpu_torch.cli import apply_overrides
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.interface.build import builder_models

    cfg = Config.fromfile(args.config_file)
    if args.overrides:
        apply_overrides(cfg["config"], args.overrides)
    return builder_models(**cfg["config"], device=args.device)


def require_matplotlib(flag: str) -> None:
    """Raise before any work when ``flag`` asks for jpg renders and matplotlib is missing."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError(f"{flag} renders jpgs with matplotlib, which is not installed")


def vis_utils(interface, dataset):
    """The ``VisUtils`` of the configuration's ``train_cfg.log.vis_downscale_cfg`` (the JAX tools'),
    its coastlines from the dataset's landsea raster unless the configuration names one."""
    import os

    from deepphysinet_tpu_torch.utils.vis import VisUtils

    vis_cfg = dict(interface.train_cfg["log"].get("vis_downscale_cfg", {}))
    vis_cfg.setdefault("landsea_file", os.path.join(dataset.constant_path, "landsea.tiff"))
    return VisUtils(**vis_cfg)


def chunks(items, num_threads: int) -> list:
    """``items`` whole when ``num_threads <= 0``, else split into ``num_threads`` contiguous slices
    (some empty when there are fewer items), as the JAX tools split their file lists."""
    if num_threads <= 0:
        return [items]
    return [items[i * len(items) // num_threads:(i + 1) * len(items) // num_threads] for i in range(num_threads)]


def run_workers(fn, jobs, num_threads: int) -> list:
    """``fn(*job)`` for each job, in job order: in this process when ``num_threads <= 0``, else in a
    pool of ``num_threads`` spawned processes (``fn`` a module-level function, so that the pool can
    pickle it).  Every job's result is waited on, so a worker's exception is raised here, and a
    worker that dies raises ``BrokenProcessPool``."""
    if num_threads <= 0:
        return [fn(*job) for job in jobs]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(num_threads, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = [pool.submit(fn, *job) for job in jobs]
        return [p.result() for p in pending]


def open_netcdf(data_file: str):
    """``netCDF4.Dataset(path).variables`` where netCDF4 is installed; without it, classic files
    (magic ``CDF``) through ``data/netcdf_classic.py`` and netCDF-4 / HDF5 files through
    ``data/hdf5_lite.py``, both with CF mask-and-scale applied on access."""
    try:
        from netCDF4 import Dataset
    except ImportError:
        pass
    else:
        return Dataset(data_file).variables
    with open(data_file, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"CDF":
        from deepphysinet_tpu_torch.data.netcdf_classic import open_variables
    else:
        from deepphysinet_tpu_torch.data.hdf5_lite import open_variables
    return open_variables(data_file)


def run_etl(grib_dir: str, era5_dir: str, work_dir: str, start, end, step_hours: int, max_lead: int) -> dict:
    """The ETL tools' ``main(argv)`` in process, in the README's order, from the GRIB2 files of
    ``grib_dir`` and the ERA5 NetCDF files of ``era5_dir`` to a tree under ``work_dir``:
    ``nc/`` (the per-level netCDF files), ``input/NCEP/<year>/`` (the GFS rasters, rio included),
    ``labels/`` (the hourly ERA5 rasters, rio included), ``stats/`` (``calc_mean_std``'s files) and
    ``input_map.pickle``, indexing the init times ``start`` .. ``end`` (datetimes) every
    ``step_hours`` with leads 0 .. ``max_lead``; the labels kept are those of ``start`` .. ``end`` +
    ``max_lead`` hours.  Every tool runs without workers.  Returns the tree's paths, each tool's
    result and each tool's host-clock seconds."""
    import datetime
    import os
    import time

    from deepphysinet_tpu_torch.tools import (calc_mean_std, calc_rio, cvt_grib_to_nc, extract_variable_from_ERA5,
                                              extract_variable_from_nc, generate_input_map)

    fmt = "%Y-%m-%d-%H:%M:%S"
    nc, inputs = os.path.join(work_dir, "nc"), os.path.join(work_dir, "input", "NCEP")
    labels, map_file = os.path.join(work_dir, "labels"), os.path.join(work_dir, "input_map.pickle")
    label_end = end + datetime.timedelta(hours=max_lead)
    calls = [
        ("cvt_grib_to_nc", cvt_grib_to_nc, ["--data_path", grib_dir, "--result_path", nc]),
        ("cvt_grib_to_nc --pressure", cvt_grib_to_nc, ["--data_path", grib_dir, "--result_path", nc, "--pressure"]),
        ("extract_variable_from_nc", extract_variable_from_nc, ["--data_path", nc, "--result_path", inputs]),
        ("extract_variable_from_nc --pressure", extract_variable_from_nc,
         ["--data_path", nc, "--result_path", inputs, "--pressure"]),
        ("extract_variable_from_ERA5", extract_variable_from_ERA5,
         ["--data_path", era5_dir, "--result_path", labels, "--start_time", start.strftime(fmt),
          "--end_time", label_end.strftime(fmt)]),
        ("calc_rio input", calc_rio, ["--data_path", inputs]),
        ("calc_rio labels", calc_rio, ["--data_path", labels]),
        ("calc_mean_std", calc_mean_std, ["--data_path", inputs, "--result_path", os.path.join(work_dir, "stats")]),
        ("generate_input_map", generate_input_map,
         ["--data_path", inputs, "--result_file", map_file, "--start_time", start.strftime(fmt),
          "--end_time", end.strftime(fmt), "--step_hours", str(step_hours), "--max_lead", str(max_lead)]),
    ]
    results, seconds = {}, {}
    for name, tool, argv in calls:
        t0 = time.perf_counter()
        results[name] = tool.main(argv)
        seconds[name] = time.perf_counter() - t0
    return dict(paths=dict(input_path=os.path.dirname(inputs), label_path=labels, input_map_file=map_file),
                results=results, seconds=seconds)
