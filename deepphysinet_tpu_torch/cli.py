"""The port's command line: ``python -m deepphysinet_tpu_torch.cli --config_file configs/X.py``.

Counterpart of the repository's ``train.py`` for the port: it loads the Python-dict
configuration (``config/config.py``), applies ``--set key.path=value`` overrides with
``train.py``'s typo guard, and runs the mode the configuration or ``--mode`` names.  Only
``inference`` is ported (``inference/runner.py::run_inference``: a checkpoint and a GeoTIFF tree
in, GeoTIFFs and jpg renders out); ``train`` waits for the trainer (ROADMAP A4) and ``test`` for
the evaluation tools (ROADMAP A6).  It runs on the first CUDA device unless ``--device`` says
otherwise.  For example, on a tree that ``data/synthetic.py::generate_synthetic_dataset`` wrote:

    python -m deepphysinet_tpu_torch.cli --config_file configs/DeepPhysiNet_NCEP_cfg.py \\
        --mode inference --checkpoints_path ckpt/ \\
        --set train_cfg.valid_data.input_path=tree/input ... \\
        --set inference_cfg.start_time=2008-01-01_06_00_00 --set inference_cfg.log.with_vis=False
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Optional, Sequence

from deepphysinet_tpu_torch.config.config import Config, update_params

_NOT_PORTED = {"train": "the trainer (ROADMAP A4)", "test": "the evaluation tools (ROADMAP A6)"}


def apply_overrides(config: dict, items) -> None:
    """Apply ``--set key.path=value`` overrides onto ``config`` (``train.py:35-72``).

    Values parse as Python literals when possible, else as raw strings.  ``update_params``
    creates missing keys, so a misspelled key would be taken with no effect on the run: a
    non-dict intermediate node is never clobbered, and a new leaf is warned about."""
    kv = {}
    for item in items:
        key, _, raw = item.partition("=")
        try:
            kv[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            kv[key] = raw
    for key in kv:
        node = config
        parts = key.split(".")
        for i, p in enumerate(parts[:-1]):
            if not isinstance(node, dict) or p not in node:
                node = None
                break
            if not isinstance(node[p], dict):
                raise SystemExit(f"--set {key}: config.{'.'.join(parts[:i + 1])} is not a dict; refusing to clobber it")
            node = node[p]
        if node is None or parts[-1] not in node:
            print(f"warning: --set {key} creates a NEW config key (not present in the config file); "
                  f"check the spelling if you meant to override an existing one")
    update_params(config, kv)


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line; returns what the mode returns (inference: ``run_inference``'s list)."""
    parser = argparse.ArgumentParser("DeepPhysiNet on PyTorch")
    parser.add_argument("--config_file", type=str, default="configs/DeepPhysiNet_NCEP_cfg.py")
    parser.add_argument("--checkpoints_path", type=str, default=None)
    parser.add_argument("--mode", type=str, default=None, choices=[None, "train", "test", "inference"], nargs="?")
    parser.add_argument("--device", type=str, default=None, help="torch device, e.g. cpu; default the first CUDA device")
    parser.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                        help="dotted config override applied to config.*, e.g. --set inference_cfg.log.with_vis=False "
                             "(values parsed as python literals when possible)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    if args.overrides:
        apply_overrides(cfg["config"], args.overrides)
    mode = args.mode or cfg.get("mode", "train")
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"--mode {mode} is not ported yet: it waits for {_NOT_PORTED[mode]}")
    from deepphysinet_tpu_torch.inference.runner import run_inference

    results = run_inference(cfg["config"], checkpoint_path=args.checkpoints_path, device=args.device)
    print(f"inference: {len(results)} hours" + (f", {results[0][0]} to {results[-1][0]}" if results else ""))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
