"""On-card check of the PyTorch port: builds its CUDA kernel and drives inference.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. build   -- compile ``deepphysinet_tpu_torch/csrc/decode_primal.cu`` with nvcc;
2. kernel  -- the decode kernel against its plain PyTorch version on the card,
              at 37,265 (one 145 x 257 frame), 1,000 and 3 points, bf16 and f32;
3. slice   -- the flagship model (configs/DeepPhysiNet_NCEP_cfg.py, random
              weights from a seeded generator) on a seeded synthetic window:
              ``predict_grid`` at three time offsets and ``predict_points`` at
              3, 300 and 50,000 points, with the launch count of the kernel,
              output checks, and one frame against the plain decode;
4. timing  -- kernel and plain decode at 37,265 points (CUDA events), and one
              full frame split into host conditioning, encode and decode.

The last three lines of standard output are a JSON object with each kernel's
numbers, the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py")
GRID_POINTS = 145 * 257
MFLOP_PER_POINT = 6 * 2 * (192 * 256 + 256 * 256 + 192 * 256) / 1e6  # 1.97

# Kernel against plain version, as max |kernel - plain| <= TOL * (1 + max |plain|).
# Both sides use the same rounding points, so what is left is float32
# summation order (the kernel sums in another order than cuBLAS): 2.9e-6 at
# max |plain| ~ 17 on random weights, in bf16 and f32 alike.  bf16 keeps
# room for a summation difference to flip one rounding of p (2^-8 of one of
# 256 terms) before the w2f1 product.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from deepphysinet_tpu.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.models.init import init_parameters
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
    from deepphysinet_tpu_torch.ops import cuda_build
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.physics.engine import _kernel_inputs
    from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack_t

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    dk._library()
    log(f"[build] {dk.SOURCE} built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.BUILD_LOGS.get(dk.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    # ---- set-up: flagship model and window -------------------------------------
    cfg = Config.fromfile(FLAGSHIP_CFG)["config"]
    cd = torch.bfloat16 if cfg["train_cfg"]["tpu"]["compute_dtype"] == "bfloat16" else torch.float32
    model = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], compute_dtype=cd, device=dev)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    window = synthetic_window(cfg, seed=0)
    dcfg = runner.decode_config_from_cfg(cfg)
    field = torch.from_numpy(window.field[None]).to(dev)
    log(f"[setup] field {tuple(field.shape)}, NWP cube {window.nwp_cube.shape}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, compute {cd}")

    def frame_inputs(time_h: float, dtype):
        """Kernel inputs of one full-grid frame (the main path's shapes)."""
        xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
        px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, time_h))
        coords = torch.from_numpy(np.stack([px, py, pt], -1)).to(dev)
        nwp_t = torch.from_numpy(nwp).to(dev)
        fh_norm = window.forecast_h / dcfg.forecast_time_period
        tokens = runner._encode(model, field, fh_norm)
        fh = torch.tensor([fh_norm], device=dev)
        with torch.no_grad():
            weights, pe, cd_pe = _kernel_inputs(model, tokens, coords, nwp_t, fh, dcfg.coord_spec)
        fw = dk.fuse_decode_weights(weights)
        return fw, pe.to(dtype), cd_pe.to(dtype), nwp_t.t().contiguous()

    # ---- 2. kernel against plain version ------------------------------------------
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        fw, pe, cd_pe, ref_t = frame_inputs(6.5, dtype)
        for n in (GRID_POINTS, 1000, 3):
            got = dk.decode_primal_v4t(fw, pe[:n].contiguous(), cd_pe[:n].contiguous(),
                                       ref_t[:, :n].contiguous(), dtype)
            torch.cuda.synchronize()
            want = dk.decode_primal_v4t_ref(fw, pe[:n], cd_pe[:n], ref_t[:, :n], dtype)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            bound = TOL[dtype] * (1.0 + scale)
            errs[(dtype, n)] = err
            log(f"[kernel] {str(dtype):15s} N={n:6d}: max|kernel-plain| {err:.3e} "
                f"(max|plain| {scale:.3f}, bound {bound:.3e})")
            if not (got.shape == (6, n) and torch.isfinite(got).all() and err <= bound):
                raise AssertionError(f"decode kernel disagrees with its plain version "
                                     f"({dtype}, N={n}): {err} > {bound}")

    # ---- 3. the slice ------------------------------------------------------------------
    rng = np.random.RandomState(1)
    queries = []
    for n in (3, 300, 50000):
        lon = window.begin_lon + rng.rand(n) * (window.out_lon[-1] - window.begin_lon)
        lat = window.begin_lat + rng.rand(n) * (window.out_lat[-1] - window.begin_lat)
        queries.append((lon, lat, rng.rand(n) * 24.0))
    dk.decode_primal_v4t.launches = 0
    grids = {h: runner.predict_grid(model, dcfg, window, field, window.forecast_h, h)
             for h in (0.0, 6.5, 23.0)}
    points = [runner.predict_points(model, dcfg, window, field, window.forecast_h, *q) for q in queries]
    torch.cuda.synchronize()
    launches = dk.decode_primal_v4t.launches
    expected = 3 + 1 + 1 + 2  # 50,000 points decode in two chunks of at most 40,960
    log(f"[slice] decode kernel launches in the main path: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"main path launched the decode kernel {launches} times, not {expected}")

    bounds = [cfg["obs_norm_cfg"][k].get("bound") for k in ("u10", "v10", "pres", "t2", "q2", "rio")]
    for h, g in grids.items():
        for i, (k, a) in enumerate(g.items()):
            if a.shape != (145, 257) or not np.isfinite(a).all():
                raise AssertionError(f"grid {k} at {h} h: shape {a.shape}, finite {np.isfinite(a).all()}")
            if i >= 2 and not (bounds[i][0] <= a.min() and a.max() <= bounds[i][1]):
                raise AssertionError(f"grid {k} at {h} h outside its clip bounds {bounds[i]}")
        log(f"[slice] grid at {h:4.1f} h: " + ", ".join(f"{k} {a.mean():.4g}" for k, a in g.items()))
    for q, p in zip(queries, points):
        if p.shape != (len(q[0]), 6) or not np.isfinite(p).all():
            raise AssertionError(f"points: shape {p.shape}")
        for i in range(2, 6):
            if not (bounds[i][0] <= p[:, i].min() and p[:, i].max() <= bounds[i][1]):
                raise AssertionError(f"points column {i} outside its clip bounds {bounds[i]}")
        log(f"[slice] {len(q[0])} points -> {p.shape}, mean T {p[:, 3].mean():.4g} K")

    # one frame through the plain decode, called explicitly
    fw, pe, cd_pe, ref_t = frame_inputs(6.5, cd)
    plain_norm = dk.decode_primal_v4t_ref(fw, pe, cd_pe, ref_t, cd)
    plain = inverse_norm_stack_t(plain_norm, dcfg.obs_specs, with_clip=True).cpu().numpy()
    stds = np.array([s.norm_factor[1] for s in dcfg.obs_specs])[:, None]
    frame = np.stack([grids[6.5][k].reshape(-1) for k in grids[6.5]])
    frame_err = float((np.abs(frame - plain) / stds).max())  # in normalized units
    bound = TOL[cd] * (1.0 + float(plain_norm.abs().max()))
    log(f"[slice] frame at 6.5 h against the plain decode: max error {frame_err:.3e} "
        f"normalized units (bound {bound:.3e})")
    if frame_err > bound:
        raise AssertionError(f"frame disagrees with the plain decode: {frame_err} > {bound}")

    # ---- 4. timing -----------------------------------------------------------------------
    fw, pe, cd_pe, ref_t = frame_inputs(6.5, cd)
    kern = lambda: dk.decode_primal_v4t(fw, pe, cd_pe, ref_t, cd)  # noqa: E731
    plain_fn = lambda: dk.decode_primal_v4t_ref(fw, pe, cd_pe, ref_t, cd)  # noqa: E731
    for fn in (kern, plain_fn):
        for _ in range(3):
            fn()
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain", "plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_ms(kern if name == "kernel" else plain_fn, 10))
    k_ms, p_ms = statistics.median(times["kernel"]), statistics.median(times["plain"])
    log(f"[timing] decode at N={GRID_POINTS} {cd}: kernel {k_ms:.4f} ms "
        f"({MFLOP_PER_POINT * GRID_POINTS / k_ms / 1e3:.2f} TFLOP/s), plain {p_ms:.4f} ms; "
        f"runs kernel {[round(t, 4) for t in times['kernel']]} plain {[round(t, 4) for t in times['plain']]}")

    xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    split = {"host": [], "encode": [], "decode": [], "frame": []}
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, 6.5))
        t1 = time.perf_counter()
        tokens = runner._encode(model, field, fh_norm)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = runner._decode_points(model, dcfg, tokens, px, py, pt, nwp, fh_norm, True).cpu()
        t3 = time.perf_counter()
        for k, v in (("host", t1 - t0), ("encode", t2 - t1), ("decode", t3 - t2), ("frame", t3 - t0)):
            split[k].append(1e3 * v)
    split = {k: statistics.median(v[1:]) for k, v in split.items()}  # first frame is a warm-up
    log(f"[timing] one frame (median of 5, host clock): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f"; output {tuple(out.shape)}")

    print(json.dumps({"kernels": [{
        "name": "decode_primal_v4t",
        "route": "cuda",
        "source": "deepphysinet_tpu_torch/csrc/decode_primal.cu",
        "replaces": "deepphysinet_tpu/ops/decode_kernel.py:956",
        "launches": launches,
        "max_abs_err": errs[(cd, GRID_POINTS)],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
