"""The port's command line: ``python -m deepphysinet_tpu_torch.cli --config_file configs/X.py``.

Counterpart of the repository's ``train.py`` for the port: it loads the Python-dict
configuration (``config/config.py``), applies ``--set key.path=value`` overrides with
``train.py``'s typo guard, builds the interface the configuration names
(``interface/build.py::builder_models``) and runs the mode the configuration or ``--mode`` names:

* ``train``: ``InterfacePhysics.run_train_interface`` (``--max_steps``, ``--log_path``,
  ``--checkpoints_path``), after a snapshot of the port's sources into the checkpoint directory
  (``codes.zip``, as ``train.py`` zips the repository's); ``--set train_cfg.tpu.sample_mode=device``
  samples the points on the device (``--set train_cfg.tpu.ds_sampler=pool`` for the pool sampler);
  ``--dist`` trains data-parallel, one process a GPU started by ``torchrun``
  (``run_train_interface_dist``, ``train_cfg.tpu.mesh``), over NCCL unless ``--dist_backend`` names
  another (gloo: ranks on the CPU with ``--device cpu``, or several ranks sharing a card);
* ``test``: ``run_test_interface`` (held-out RMSE of a checkpoint), printed as one JSON line;
* ``inference``: ``run_inference_interface`` (a checkpoint and a GeoTIFF tree in, GeoTIFFs and jpg
  renders out).

It runs on the first CUDA device unless ``--device`` says otherwise (under ``--dist``, on the rank's
card, ``cuda:LOCAL_RANK``).  Several GPUs of one node:

    python -m torch.distributed.run --nproc_per_node 4 -m deepphysinet_tpu_torch.cli --dist \\
        --config_file configs/DeepPhysiNet_NCEP_cfg.py --mode train

and of several nodes, the same on each with ``--nnodes N --node_rank I --master_addr HOST
--master_port PORT``.  For example, on a tree that
``data/synthetic.py::generate_synthetic_dataset`` wrote:

    python -m deepphysinet_tpu_torch.cli --config_file configs/DeepPhysiNet_NCEP_cfg.py \\
        --mode inference --checkpoints_path ckpt/ \\
        --set train_cfg.valid_data.input_path=tree/input ... \\
        --set inference_cfg.start_time=2008-01-01_06_00_00 --set inference_cfg.log.with_vis=False
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import zipfile
from typing import Optional, Sequence

from deepphysinet_tpu_torch.config.config import Config, update_params

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


def zip_codes(src_dir: str, dst_file: str) -> None:
    """Source snapshot into the checkpoint directory (``train.py:23``; reference train.py:45-46)."""
    with zipfile.ZipFile(dst_file, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(src_dir):
            dirs[:] = [d for d in dirs if d not in (".git", "__pycache__", "checkpoints", "log", "results", "build")]
            for f in files:
                if f.endswith((".py", ".md", ".cu", ".cuh")):
                    p = os.path.join(root, f)
                    zf.write(p, os.path.relpath(p, src_dir))


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
    """Run the command line; returns what the mode returns (train: the final ``TrainState``; test:
    the metrics; inference: ``run_inference``'s list)."""
    parser = argparse.ArgumentParser("DeepPhysiNet on PyTorch")
    parser.add_argument("--config_file", type=str, default="configs/DeepPhysiNet_NCEP_cfg.py")
    parser.add_argument("--checkpoints_path", type=str, default=None)
    parser.add_argument("--log_path", type=str, default=None)
    parser.add_argument("--dist", action="store_true",
                        help="data-parallel training, one process a GPU, under torchrun (train mode)")
    parser.add_argument("--dist_backend", type=str, default="nccl",
                        help="the process group's backend under --dist: nccl (default) or gloo (ranks on the CPU "
                             "with --device cpu, or several ranks sharing one card)")
    parser.add_argument("--max_steps", type=int, default=None, help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--mode", type=str, default=None, choices=[None, "train", "test", "inference"], nargs="?")
    parser.add_argument("--device", type=str, default=None, help="torch device, e.g. cpu; default the first CUDA device")
    parser.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                        help="dotted config override applied to config.*, e.g. --set inference_cfg.log.with_vis=False "
                             "(values parsed as python literals when possible)")
    args = parser.parse_args(argv)
    from deepphysinet_tpu_torch.interface.build import builder_models

    cfg = Config.fromfile(args.config_file)
    if args.overrides:
        apply_overrides(cfg["config"], args.overrides)
    mode = args.mode or cfg.get("mode", "train")
    device, owned_group = args.device, False
    if args.dist and mode == "train":
        # the rank's device before the interface is built: cuda:LOCAL_RANK, or the CPU for gloo ranks
        import torch.distributed as dist

        from deepphysinet_tpu_torch.parallel import multihost

        owned_group = not dist.is_initialized()
        device = multihost.initialize_distributed(args.dist_backend, device=args.device)
    models = builder_models(**cfg["config"], device=device)
    if mode == "train":
        checkpoint_path = args.checkpoints_path or cfg["config"]["train_cfg"]["checkpoints"]["checkpoints_path"]
        os.makedirs(checkpoint_path, exist_ok=True)
        run_kwargs = dict(checkpoint_path=args.checkpoints_path, log_path=args.log_path, max_steps=args.max_steps)
        if not args.dist:
            zip_codes(PACKAGE_DIR, os.path.join(checkpoint_path, "codes.zip"))
            return models.run_train_interface(**run_kwargs)
        if multihost.rank() == 0:
            zip_codes(PACKAGE_DIR, os.path.join(checkpoint_path, "codes.zip"))
        try:
            return models.run_train_interface_dist(backend=args.dist_backend, **run_kwargs)
        finally:
            if owned_group and dist.is_initialized():  # the group this call joined
                dist.destroy_process_group()
    if mode == "test":
        out = models.run_test_interface(checkpoint_path=args.checkpoints_path)
        print(json.dumps(out))
        return out
    results = models.run_inference_interface(checkpoint_path=args.checkpoints_path)
    print(f"inference: {len(results)} hours" + (f", {results[0][0]} to {results[-1][0]}" if results else ""))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
