"""The port's command-line tools, counterparts of the repository's ``tools/evaluate.py``,
``tools/infer_stations.py`` and ``tools/derive_products.py``:

    python -m deepphysinet_tpu_torch.tools.evaluate --config_file configs/X.py [...]
    python -m deepphysinet_tpu_torch.tools.infer_stations --config_file configs/X.py --stations s.csv
    python -m deepphysinet_tpu_torch.tools.derive_products --config_file configs/X.py [--vs_model CKPT]

Each takes the JAX tool's flags, and ``--device`` (default: the first CUDA device) and ``--set
key.path=value`` as the port's command line (``cli.py``) does.  Each ``main(argv)`` returns what
it printed or wrote, so that a caller can run it in process.
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
