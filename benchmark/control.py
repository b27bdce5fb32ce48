"""The readings that a cell's limits are set from, over many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --what program|control|<fault>
        [--out FILE]

* ``program``: the program's numbers as a run reads them (training: the checked steps of set-up;
  frames: a short closed loop of twice ``CHECKED_FRAMES`` frames), against the reference;
* ``control``: the reference computed in the precision below the configuration's
  (``precision.control`` of its file: fp8 for bfloat16, TF32 for float32) in the program's place;
* a fault of ``lib/faults.py``, planted in the program, then as ``program``.

One JSON line a seed, to standard output and, with ``--out``, appended to FILE.  The benchmark's
own runs never run this; ``tests/test_bench_control.py`` runs the control on a card.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[0] = os.path.dirname(BENCH)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(BENCH, ".cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BENCH, ".cache", "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(BENCH, ".cache", "nv"))


def program_numbers(kind, cell, seed, device):
    state = kind.setup(cell, seed, device)
    for _ in range(2 * getattr(kind, "CHECKED_FRAMES", 0)):  # a frame cell's short window
        kind.step(state)
    kind.release(state)
    return kind.numbers(state)


def readings(cell, seeds, what: str, device, out=None):
    import torch

    from benchmark.lib import faults, spec

    kind = spec.kind_module(cell.traffic)
    rows = []
    for seed in seeds:
        t0 = time.time()
        if what == "control":
            numbers = kind.control_numbers(cell, seed, device, cell.precision["control"])
        elif what == "program":
            numbers = program_numbers(kind, cell, seed, device)
        else:
            with faults.planted(what):
                numbers = program_numbers(kind, cell, seed, device)
        row = dict(workload=cell.name, what=what, seed=seed, seconds=time.time() - t0,
                   numbers={k: {kk: (float(vv) if isinstance(vv, (int, float)) else vv) for kk, vv in v.items()}
                            for k, v in numbers.items()})
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as fp:
                fp.write(line + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from benchmark.lib import spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings(cell, [int(s) for s in args.seeds.split(",")], args.what, torch.device("cuda", 0), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
