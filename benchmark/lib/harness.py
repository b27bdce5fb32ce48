"""One run of one cell: ``run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``.

1. Refuse without CUDA or with fewer cards than the cell asks for (no result, exit 3).
2. Print the card (``nvidia-smi``: name, power limit, clocks) on a line of its own.
3. Set-up: the cell's kind builds the program's objects and the inputs from the seed and warms every
   shape the cell uses; ``setup_s`` runs from the process's start to the end of set-up.
4. The window: the closed loop for ``--seconds`` (``lib/timing.py``).  With ``--trace 1``, two
   traced stretches of ``trace_steps`` units follow, the device's and the host's (``lib/trace.py``).
5. The peak device memory is read, the program's objects are dropped, and the reference
   judges what the program produced (its kind's ``numbers``, held to ``limits/<workload>.json``).
6. The metrics: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
   per-layer metrics, each from its reader in ``metrics/``.
7. If JAX or the JAX package is loaded, no result (exit 5).  Else the numbers compared go to
   standard error as the last lines, and the result to standard output as its last line, with the
   numbers compared under ``checks``, its last key.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

from benchmark.lib import card, checks, guard, spec, timing, yardstick
from benchmark.lib import trace as tracing

TRACE_DIR = os.path.join(spec.BENCH_DIR, "traces")
TRACE_WARMUP = 3  # units the profiler runs before each traced stretch


def parse(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_metrics(entries, run) -> dict:
    out = {}
    for m in entries:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, setup_start: float):
    """Set-up, the window, the traced stretch, the comparison and the metrics of one run.
    Returns (result without ``checks``, the numbers compared, its kind's numbers)."""
    import torch

    cuda = device.type == "cuda"
    kind = spec.kind_module(cell.traffic)
    if cuda:
        torch.cuda.init()
    before = time.time()
    state = kind.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - setup_start
    err(f"setup_s {setup_s:.3f}: interpreter, imports and CUDA {before - setup_start:.3f}, the cell's set-up "
        f"(kernels built or loaded, weights, inputs, first steps) {setup_s - (before - setup_start):.3f}")
    win = timing.closed_loop(lambda: kind.step(state), seconds, cuda=cuda)
    attempted, failed = win.attempted, win.failed
    reduced = None
    if trace:
        tr = cell.traffic
        warm, active = TRACE_WARMUP, int(tr["trace_steps"])
        families = list(kind.work(state)["kernels"])
        path = os.path.join(TRACE_DIR, f"{cell.name}.device.json")
        _, f_dev, seconds_dev = tracing.record(lambda: kind.step(state), warm, active, path, cpu=False)
        reduced = tracing.device_summary(tracing.events_of(path), families, seconds_dev, active)
        path = os.path.join(TRACE_DIR, f"{cell.name}.host.json")
        _, f_host, _ = tracing.record(lambda: kind.step(state), warm, active, path, cpu=True)
        reduced["idle_gaps"] = tracing.idle_by_host(tracing.events_of(path))
        attempted += 2 * (warm + active)
        failed += f_dev + f_host
    device_rec = card.device_record(cell.chips, device)
    work = kind.work(state)
    kind.release(state)

    numbers = kind.numbers(state)
    correct, compared = checks.judge(numbers, cell.limits)
    run = SimpleNamespace(setup_s=setup_s, window=win, work=work, dtype=cell.dtype, config=cell.config,
                          trace=reduced, peak_flops=yardstick.peak_flops(cell.dtype))
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    if reduced is not None:
        device_rec.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result = dict(correct=bool(correct and failed == 0 and attempted > 0), attempted=int(attempted),
                  failed=int(failed), metrics=metrics, device=device_rec)
    times = sorted(win.times_ms)
    median = times[len(times) // 2]
    slow = [t for t in times if t > 2 * median]
    print(f"unit times, ms: min {times[0]:.3f} median {median:.3f} p95 {timing.p95(times):.3f} max {times[-1]:.3f} "
          f"of {len(times)}; over twice the median: {len(slow)}, {sum(slow) / 1e3:.3f} s; "
          f"{win.units / win.seconds:.3f} units/s over {win.seconds:.3f} s", flush=True)
    if reduced is not None:
        result["breakdown"] = dict(device_ops=reduced["device_ops"], idle_gaps=reduced["idle_gaps"])
    return result, compared, numbers


def main(argv: Optional[List[str]] = None, start_epoch: Optional[float] = None) -> int:
    start_epoch = timing.process_start_epoch() if start_epoch is None else start_epoch
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        err(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); CUDA available: "
            f"{torch.cuda.is_available()}, cards: {count}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi "
          f"({card.QUERY}): {card.nvidia_smi()}", flush=True)
    result, compared, numbers = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                                         start_epoch)
    print(f"card after the run: {card.nvidia_smi()}", flush=True)
    loaded = guard.forbidden_loaded()
    if loaded:
        err(f"benchmark: the run loaded {loaded}; the port must run without JAX and the JAX package")
        return 5
    result["checks"] = compared
    for name in (n for n in numbers if n not in compared):
        err(f"reading {name} = {numbers[name]['value']!r} (not compared)")
    for name, row in compared.items():
        extra = {k: v for k, v in numbers[name].items() if k != "value"}
        err(f"check {name} = {row['value']!r} limit {row['limit']!r} {json.dumps(extra) if extra else ''}".rstrip())
    print(json.dumps(result), flush=True)
    return 0
