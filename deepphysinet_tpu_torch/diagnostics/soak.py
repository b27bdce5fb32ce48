"""The synthetic full-scale soak: train the port from scratch, then score it on held-out data.

Runs, from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.soak [--max_steps 10000] [--data DIR] [--out DIR]

1. ``python -m deepphysinet_tpu_torch.cli --config_file
   deepphysinet_tpu_torch/configs/synthetic_fullscale_cfg.py --max_steps N`` in a subprocess (the
   configuration writes its tree under ``--data``, ``DPN_FULLSYNTH_DATA``, on first load), its
   output kept in ``{out}/soak_train.log``;
2. ``python -m deepphysinet_tpu_torch.tools.evaluate --full_grid`` and ``--off_lattice`` on the
   valid split of the final checkpoint, in process.

It prints the card's name and power limit and then one JSON line: the steps and the wall seconds of
the training process, steps/s between the first and the last log line (the loop's own clock,
``t:`` of the ``[device-sampled]`` lines) and over the whole process, the steps whose gradient was
not finite (the global step less Adam's step count in the final checkpoint: a skipped step does not
step the optimizer), the device-mode validations that failed (their warnings in the log), and both
evaluations' metrics.  The final model's weights (without the optimizer state) are saved into
``{out}/model`` so that it can be scored again.  ``--set key.path=value`` passes an override to
every command (a rehearsal on the CPU shrinks the widths with it and passes ``--device cpu``).

``--seed N`` draws the initial weights from a generator seeded ``N`` (the trainer draws its own
from seed 0): where the checkpoint directory holds no ``physics_latest`` yet, they are written there
as a checkpoint of epoch -1, step 0, without an optimizer state, from which the trainer starts as
from scratch (epoch 0, step 0, fresh Adam moments).  The device draws of the points are seeded by
the step, as the JAX trainer's are, so the initial weights are what another seed changes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

CONFIG = os.path.join("deepphysinet_tpu_torch", "configs", "synthetic_fullscale_cfg.py")
_LOG_LINE = re.compile(r"^\[device-sampled\] epoch:\S+,iter:(\d+),.*,fps:([\d.]+),t:([\d.]+)s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("the port's synthetic full-scale soak")
    parser.add_argument("--max_steps", type=int, default=10000)
    parser.add_argument("--data", type=str, default=None, help="the tree's root (DPN_FULLSYNTH_DATA)")
    parser.add_argument("--out", type=str, default="soak_out")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE")
    parser.add_argument("--seed", type=int, default=None, help="the initial weights' seed (the trainer's: 0)")
    args = parser.parse_args(argv)

    from deepphysinet_tpu_torch.tools import build_interface, evaluate
    from deepphysinet_tpu_torch.train import checkpoint as ckpt

    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ)
    if args.data:
        env["DPN_FULLSYNTH_DATA"] = os.environ["DPN_FULLSYNTH_DATA"] = os.path.abspath(args.data)
    common = ["--config_file", CONFIG] + (["--device", args.device] if args.device else [])
    for item in args.overrides:
        common += ["--set", item]

    interface = build_interface(argparse.Namespace(config_file=CONFIG, overrides=args.overrides, device=args.device))
    ckpt_dir = interface.train_cfg["checkpoints"]["checkpoints_path"]
    if args.seed is not None and ckpt.load_checkpoint(ckpt_dir)[0] is None:
        import torch

        from deepphysinet_tpu_torch.train.train_step import create_train_state

        seeded = create_train_state(interface.meta_cfg, interface.net_cfg, dict(interface.train_cfg["optimizer"]),
                                    torch.Generator().manual_seed(args.seed), compute_dtype=interface.compute_dtype,
                                    device=interface.device, attn_impl=interface.attn_impl).model
        ckpt.save_checkpoint(ckpt_dir, -1, 0, seeded, None)

    train_log = os.path.join(args.out, "soak_train.log")
    t0 = time.perf_counter()
    with open(train_log, "w") as fp:
        proc = subprocess.run([sys.executable, "-m", "deepphysinet_tpu_torch.cli", *common,
                               "--max_steps", str(args.max_steps)], env=env, stdout=fp, stderr=subprocess.STDOUT)
    wall_s = time.perf_counter() - t0
    text = open(train_log).read()
    if proc.returncode != 0:
        print(text[-4000:], file=sys.stderr)
        raise SystemExit(f"the training command failed with exit code {proc.returncode}")
    logged = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
              for m in map(_LOG_LINE.match, text.splitlines()) if m]
    failed_validations = text.count("device-mode validation failed")

    payload, epoch, step = ckpt.load_checkpoint(ckpt_dir)
    adam_steps = sorted({int(v["step"]) for v in payload["optimizer"]["state"].values()})

    scores = {}
    for mode in ("--full_grid", "--off_lattice"):
        with contextlib.redirect_stdout(io.StringIO()):
            scores[mode[2:]] = evaluate.main(common + ["--split", "valid_data", mode])

    model, _, _ = interface.load_physics_net(ckpt_dir)
    meta = {k: v for k, v in payload.items() if k not in ("model", "optimizer", "param_names")}
    ckpt.save_checkpoint(os.path.join(args.out, "model"), epoch - 1, step, model, None, **meta)

    card = "not measured (no nvidia-smi)"
    with contextlib.suppress(OSError, subprocess.CalledProcessError):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    loop = (logged[-1][0] - logged[0][0]) / (logged[-1][2] - logged[0][2]) if len(logged) > 1 else None
    print(card)
    print(json.dumps({"steps": step, "epoch": epoch - 1, "wall_s": wall_s, "steps_per_s_process": step / wall_s,
                      "steps_per_s_loop": loop, "log_lines": len(logged), "adam_steps": adam_steps,
                      "skipped_nonfinite": step - max(adam_steps), "failed_validations": failed_validations,
                      "seed": args.seed,
                      **scores}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
