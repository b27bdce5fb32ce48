"""On-card check of the PyTorch port: builds its CUDA kernels, drives inference, training
and the evaluation sweeps.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. build    -- compile the six sources under ``deepphysinet_tpu_torch/csrc/`` with
               nvcc, all at once, and log registers, spills and shared memory;
2. primal   -- the primal decode kernel against its plain PyTorch version on the
               card, at 37,265 (one 145 x 257 frame), 1,000 and 3 points, bf16 and f32;
3. infer    -- the flagship model (configs/DeepPhysiNet_NCEP_cfg.py, random weights
               from a seeded generator) on a seeded synthetic window:
               ``predict_grid`` at three time offsets and ``predict_points`` at 3, 300
               and 50,000 points, with the launch count of the kernel, output
               checks, and one frame against the plain decode;
4. forward  -- the v4s forward kernel (primal + three tangents) against its plain
               version at 20,480, 4,096, 1,000 and 3 points of one flagship window,
               bf16 and f32;
5. backward -- the v4s backward kernel against its plain version at the same sizes
               with seeded random cotangents, per weight; and the
               ``torch.autograd.Function`` that joins the two kernels against
               autograd of the plain forward (weights, ``ref_t``, the zero cotangents);
6. train    -- the flagship training step under the ``'kernel'`` engine on a seeded
               synthetic batch (20,480 margin + 4,096 collocation points): 3
               data-only steps, then 3 steps with the PDE terms, with the launch
               counts of both kernels; then, from one starting state, the
               gradients of one PDE step under ``'kernel'`` against ``'jvp'`` (the
               plain version under autograd);
7. v4       -- the v4 forward and backward kernels against their plain versions in
               both layouts ([N, 6] and [6, N]), bf16 and f32, at 37,265, 20,480, 4,096,
               1,000 and 3 points of one flagship frame; the two layouts against each
               other; two runs of the backward; and ``FusedDecodeJvpV4`` in both
               layouts against autograd of the plain forward;
8. eval     -- the evaluation sweeps on one seeded flagship window with a label cube:
               ``evaluate_residuals`` (25 hours x 37,265 points through the v4t
               forward kernel), ``residual_field_maps`` (one [N, 6] forward launch)
               and ``evaluate_rmse_fullgrid`` (25 primal launches), with the launch
               counts, finite outputs, and the residual sweep against the same
               sweep on the plain version;
9. train v4 -- from the seeded state: one PDE step's loss and gradients under
               ``kernel_version=4`` ('kernel' against 'jvp', and against
               ``kernel_version=7``) and under ``'linearize'``; then 3 PDE steps with
               ``kernel_version=4`` (the v4t pair), 1 with ``var_major`` off (the
               [N, 6] pair) and 1 under ``'linearize'``, with the launch counts;
10. v6      -- the v6 forward and backward kernels against their plain versions,
               bf16 and f32, at 20,480, 4,096, 1,000 and 3 points; the forward
               against the v4s kernel on the same points and weights (the same
               bits); two runs of the backward; ``FusedDecodeJvpV6`` against
               autograd of the plain forward;
11. residual -- the two residual-sum kernels (decode and PDE assembly in one launch)
               against their plain versions, bf16 and f32, ``with_clip`` on and off,
               at 49,152, 65,536 and 50,001 points of the window, each beside a
               float64 sum of the plain version's per-point terms; two runs (the
               same bits); against the split path on the same points; then the
               entry points: ``fused_residual_losses(version=6)`` at 40,960 (split
               branch) and 65,536 points (in-kernel) and
               ``kernel_residual_losses(version=4)`` at 65,536, with the launch counts;
12. train v6 -- from the seeded state: one PDE step under ``kernel_version=6``
               ('kernel' against 'jvp', and against ``kernel_version=7``); then 3 PDE
               steps with ``kernel_version=6``, with the launch counts;
13. timing  -- by CUDA events, medians, alternating order: each kernel and its
               plain version at the main paths' sizes, and the in-kernel residual
               assembly against the split path at 40,960 to 131,072 points; by host
               clock around a synchronize: one frame, one training step of each
               kind and one residual sweep, split into their parts;
14. profile -- only with ``--profile``: ``torch.profiler`` over three steps of each
               kind, three frames and three residual sweeps, for the device's busy share.

The last three lines of standard output are a JSON object with each kernel's
numbers, the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
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
V4S_SIZES = (20480, 4096, 1000, 3)
V4_SIZES = (GRID_POINTS, 20480, 4096, 1000, 3)  # one evaluation frame, the step's launches, ragged edges
TIMING_POINTS = 20480 + 4096  # the points one PDE step decodes
# the residual-sum kernels: at and above the engine's crossover, one ragged size; the split
# branch's size; the sizes of the in-kernel against split timing
RESIDUAL_SIZES = (49152, 65536, 50001)
RESIDUAL_MAIN_N, RESIDUAL_SPLIT_N = 65536, 40960
CROSSOVER_SIZES = (40960, 49152, 65536, 131072)

# The card's published peaks (NVIDIA H100 SXM data sheet): dense bf16 tensor-core
# rate and HBM3 bandwidth.  A kernel's bound is the larger of its operations
# over the first and its bytes (inputs read once, outputs written once) over
# the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Primal kernel against plain version, as max |kernel - plain| <= TOL * (1 + max |plain|).
# Both sides use the same rounding points, so what is left is float32
# summation order (the kernel sums in another order than cuBLAS): 2.9e-6 at
# max |plain| ~ 17 on random weights, in bf16 and f32 alike.  bf16 keeps
# room for a summation difference to flip one rounding of p (2^-8 of one of
# 256 terms) before the w2f1 product.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}

# v4s forward kernel against its plain version: the primal as above; each
# tangent output relative to its own largest value (the tangents carry the
# folded scale 1 / (dx (lon - 1)) ~ 1e-7, so an absolute floor would hide them).
# Same rounding points on both sides (p in f32 for the w2wo sum, the masked
# tangents rounded once); measured 3e-6 on the primal and 2e-7 of the largest
# tangent in both dtypes.  bf16 keeps the same room for a flipped rounding of p
# or of a tangent.
TOL_TANGENT = {torch.float32: 1e-5, torch.bfloat16: 1e-3}

# v4s backward kernel against its plain version, per weight, as
# max |kernel - plain| <= RTOL_BWD * max |plain| of that weight.  Both sides
# round every operand of every product at the same places; what is left is the
# float32 summation order, which the kernel's atomic adds change from run to run
# (measured 2e-6 in f32 and bf16).  The JAX tests hold the f32 TPU kernel to 5e-4
# of each weight's largest cotangent; f32 here is held to 1e-4.  bf16 gets 2e-3:
# a summation difference upstream may flip the bf16 rounding of an operand
# (2^-9 relative of one term of a sum over up to 20,480 points).
RTOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-3}

# The v4 pair is held to the same three bounds as the v4s pair: TOL on the primal,
# TOL_TANGENT on each tangent, RTOL_BWD per weight.  Its two layouts run the same
# arithmetic and differ only in the addresses of the ref / cotangent loads and of
# the output stores, so the forward's layouts must agree to the bit; the backward's
# differ by the order of the atomic adds, like two runs of one layout, and are held
# to RTOL_BWD.
#
#
# The decode is not continuous in its sums: a relu argument (z or r) that the kernel's
# summation order puts on the other side of zero than cuBLAS's switches one of 256
# terms of a tangent on or off.  At 37,265 points x 6 variables x 512 relu arguments
# a few always lie that close, and float32 reads 6e-4 of a tangent's largest value
# from them where every other point agrees to 2e-7.  So the v4 checks leave out the
# points at which any relu argument of the plain version lies within KINK_EPS *
# (1 + the largest argument) of zero (ten times the primal's disagreement relative
# to its scale): the forward is compared on the others, and the backward's cotangents
# are zero there (every output is linear in them, point by point).  The share left
# out is printed and must stay under KINK_SHARE (or be one point: 3 to 4% of the points
# lie that close, so at the 3-point size one of them does in a tenth of the runs).
KINK_EPS = 2e-6
KINK_SHARE = 0.2
#
# The residual sweep through the kernel against the same sweep through the plain
# version, per returned number: the bar at which the CPU parity test holds the
# port's sweep to the JAX package's (means over 25 x 37,265 points of squared
# differences of large terms).
RTOL_SWEEP = 2e-3

# The residual-sum kernels against their plain versions, per equation, relative to the
# plain sum.  Both sides decode with the same rounding points and assemble term by term in
# the same order of float32 operations (the device code uses explicitly rounded operations,
# no FMA contraction), so what is left is the decode's summation order, carried through
# differences of large terms, and the order of the sum over the points (the kernel: a
# block, then blocks in order; the plain version: torch.sum).  float32 is held to 1e-4,
# the bar of the JAX package's tests at 64 points; bf16 to 2e-3, where a summation
# difference may flip the bf16 rounding of p or of a tangent (as RTOL_BWD).  The vapor
# equation switches a whole term on delta = 1[Dp/Dt < 0 and q >= q_s]: a point within
# SWITCH_EPS of either switch may land on the other side in the kernel, only sums come
# out, so that equation alone is also allowed the size of those points' terms (printed
# with their count).  The same bounds hold the in-kernel path to the split path through
# the entry points.
RTOL_RESIDUAL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
SWITCH_EPS = {torch.float32: 1e-5, torch.bfloat16: 1e-3}

# One PDE step under kernel_version=4 against kernel_version=7, both under 'kernel'.
# The two pairs compute the same function with different rounding points of the
# tangent input (v4 rounds dpe = f cos(.) * scale to the compute type, v4s rounds
# the folded weights f * scale * w1), so they are held to STEP_TIMES_EXPLAINED times
# what their plain versions differ by under autograd ('jvp' 4 against 'jvp' 7), or
# the run-to-run spread if that is larger; the loss to RTOL_VERSIONS_LOSS of the
# compute type (a bf16 rounding of every tangent input is 2^-9 relative).
RTOL_VERSIONS_LOSS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# kernel_version=6 against 7 is held the same way: one fold, one set of fused weights,
# another operand layout.  Under kernel_version=6 the step's 'jvp' engine is the plain
# version with the XLA twin's rounding (masked tangents float32 in the w2wo sum, the cd PE
# float32 in the wdwo sum), where 'kernel' rounds both to the compute type.  With bf16
# compute that is another forward, whose last bits move the density net's gradients by more
# than a tenth (C6), so the engine comparison of kernel_version=6 runs 'jvp' on the plain
# version with the KERNEL's rounding, as the var-major 'jvp' of versions 4 and 7 has it;
# the twin's loss is held to the 'kernel' loss at RTOL_VERSIONS_LOSS beside it.  The plain
# versions of 6 and 7 are then one function to the bit and the two kernels one arithmetic,
# so 6 against 7 under 'kernel' is one more sample of 'run to run' (the order of the atomic
# adds) held to two other samples: readings of one state spread by a factor of 2.3 (1.6e-6
# to 3.7e-6 in float32), so the multiple is NOISE_TIMES, not STEP_TIMES_EXPLAINED.
NOISE_TIMES = 4.0
# 'linearize' (forward mode through the per-variable decode) against 'jvp' (the
# collapsed algebra) on the total loss of one PDE step.  In float32 the two are the
# same function up to the association of the products; with bf16 compute the
# per-variable decode rounds every layer's output to bf16 where the collapsed
# decode keeps float32 sums, so only a loose bound holds.
RTOL_LINEARIZE_LOSS = {torch.float32: 1e-3, torch.bfloat16: 1e-1}

# One PDE step under 'kernel' against 'jvp', from the seeded starting state.  The
# forwards agree to the kernel tolerance, so the losses do (RTOL_STEP_LOSS).  The
# gradients are compared per parameter, relative to that parameter's largest
# gradient entry, three ways, and the script prints all three readings:
#   'same forward'   'kernel' against 'jvp' carrying the kernel's forward values to
#                    the last bit, so that both backwards get the same cotangents:
#                    what is left is the backward kernel against autograd;
#   'forward alone'  'jvp' carrying the kernel's forward values against 'jvp': what
#                    the forwards' last-bit difference alone does to the gradients.
#                    The residuals are differences of large terms (the gas law
#                    subtracts two pressures of 1e5 Pa), so it is far above float32
#                    rounding on the density net, whose gradient is a small share
#                    of the norm;
#   'run to run'     two runs of 'kernel', which differ by the order of the backward
#                    kernel's atomic adds.
# Limits as (gradient norm, 'same forward'); 'kernel' against 'jvp' is held to
# STEP_TIMES_EXPLAINED times the larger of 'forward alone' and 'run to run'.  Measured
# on an H100, with float32 compute: 'kernel' against 'jvp' 3.71e-3 and 'forward alone'
# 3.72e-3 on the same density-net parameters, 'same forward' 7.1e-6, 'run to run'
# 2.1e-6.  The two backwards do the same arithmetic in another order, so 'same
# forward' has the backward kernel's own limit.  With bf16 compute: 1.54e-2,
# 1.53e-2, 9.6e-3 and 6.3e-3.  There the backwards round the cotangents at different
# places (the backward kernel rounds g_rp, g_rt, g_z, g_tz as product inputs, as the
# TPU kernel does; autograd rounds where the plain forward cast), and bf16 autograd
# through the fusion and the encoder amplifies any difference, because a changed
# input flips roundings of 2^-9; 'same forward' (None) is held to the multiple too.
#
# 'Same forward' is not the backward kernel alone: the kernel recomputes the forward
# and takes the relu masks from its own sums, autograd of the plain forward takes
# them from cuBLAS's, and a mask that differs at one of 24,576 x 6 x 512 places moves
# a gradient by that point's share, which is large where a few points carry the
# residuals.  Measured with float32 compute: 7.1e-6 under kernel_version=7, 1.8e-4
# (q_net.cat_fc1) under kernel_version=4 with the same backward arithmetic, held to
# 1e-6 on random cotangents in phase 7.  So its float32 limit is the backward
# kernel's own or SAME_FORWARD_SHARE of 'forward alone', whichever is larger: the
# backward must explain at most a tenth of what the forward's last bits do.
RTOL_STEP_LOSS = 1e-4
RTOL_STEP = {torch.float32: (1e-4, RTOL_BWD[torch.float32]), torch.bfloat16: (5e-3, None)}
STEP_TIMES_EXPLAINED = 2.0
SAME_FORWARD_SHARE = 0.1
# A parameter's gradient is noise, not signal, when last-bit changes of the forward
# alone move it by more than this share of its largest entry under 'jvp' (signal
# moves by under 1e-2).  Softmax is invariant to the key-projection bias, so
# its exact gradient is zero and what autograd returns is rounding.  Such a
# parameter is held to ZERO_GRAD_NOISE of the gradient norm under both engines.
NOISE_SHARE = 0.1
ZERO_GRAD_NOISE = 1e-5


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


def alternating_ms(kernel_fn, plain_fn, iters: int):
    """Median ms of kernel and plain version over four runs each, in turns."""
    for fn in (kernel_fn, plain_fn):
        for _ in range(2):
            fn()
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain", "plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_ms(kernel_fn if name == "kernel" else plain_fn, iters))
    return statistics.median(times["kernel"]), statistics.median(times["plain"]), times


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.eval import common as eval_common
    from deepphysinet_tpu_torch.eval.residuals import evaluate_residuals, residual_field_maps
    from deepphysinet_tpu_torch.eval.rmse import evaluate_rmse_fullgrid
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import cuda_build
    from deepphysinet_tpu_torch.ops.coords import coriolis
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.ops import residual_kernel as rk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts
    from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack_t

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 1. build ------------------------------------------------------------
    sources = dk.SOURCES + (rk.SOURCE,)
    t0 = time.perf_counter()
    cuda_build.build_libraries(sources)
    dk._library()
    for source in dk.SOURCES[1:]:
        dk._jvp_library(source)
    rk._library()
    log(f"[build] {', '.join(sources)} built together and loaded in {time.perf_counter() - t0:.1f} s")
    for source in sources:
        for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {source}: {line.strip()}")

    # ---- set-up: flagship model, window and batch ---------------------------------
    cfg = Config.fromfile(FLAGSHIP_CFG)["config"]
    cd = torch.bfloat16 if cfg["train_cfg"]["tpu"]["compute_dtype"] == "bfloat16" else torch.float32
    state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                  torch.Generator().manual_seed(0), compute_dtype=cd, device=dev)
    model = state.model
    window = synthetic_window(cfg, seed=0)
    dcfg = runner.decode_config_from_cfg(cfg)
    scfg = ts.step_config_from_cfg(cfg)
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    field = torch.from_numpy(window.field[None]).to(dev)
    n_vars = len(dcfg.obs_specs)
    log(f"[setup] field {tuple(field.shape)}, NWP cube {window.nwp_cube.shape}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, compute {cd}; batch "
        f"{batch.margin.x.shape[1]} margin + {batch.inter.x.shape[1]} collocation points, "
        f"engine {scfg.pde_engine!r}, optimizer {cfg['train_cfg']['optimizer']}")

    def frame_inputs(time_h: float, dtype, with_tangents: bool = False):
        """Primal-kernel inputs of one full-grid frame (the inference and evaluation paths'
        shapes); with the compact tangent input ``dpe`` after ``pe`` on request."""
        xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
        px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, time_h))
        coords = torch.from_numpy(np.stack([px, py, pt], -1)).to(dev)
        nwp_t = torch.from_numpy(nwp).to(dev)
        fh_norm = window.forecast_h / dcfg.forecast_time_period
        tokens = runner._encode(model, field, fh_norm)
        fh = torch.tensor([fh_norm], device=dev)
        with torch.no_grad():
            weights, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens, coords, nwp_t, fh, dcfg.coord_spec)
            fw = dk.fuse_decode_weights(weights)
        if with_tangents:
            return fw, pe.to(dtype), dpe.to(dtype), cd_pe.to(dtype), nwp_t.t().contiguous()
        return fw, pe.to(dtype), cd_pe.to(dtype), nwp_t.t().contiguous()

    # ---- 2. primal kernel against plain version -------------------------------------
    errs, rel_errs = {}, {}  # absolute; and as a share of what the tolerance is stated in
    for dtype in (torch.bfloat16, torch.float32):
        fw, pe, cd_pe, ref_t = frame_inputs(6.5, dtype)
        for n in (GRID_POINTS, 1000, 3):
            got = dk.decode_primal_v4t(fw, pe[:n].contiguous(), cd_pe[:n].contiguous(),
                                       ref_t[:, :n].contiguous(), dtype)
            torch.cuda.synchronize()
            want = dk.decode_primal_v4t_ref(fw, pe[:n], cd_pe[:n], ref_t[:, :n], dtype)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            limit = TOL[dtype] * (1.0 + scale)
            errs[(dtype, n)], rel_errs[(dtype, n)] = err, err / (1.0 + scale)
            log(f"[primal] {str(dtype):15s} N={n:6d}: max|kernel-plain| {err:.3e} "
                f"(max|plain| {scale:.3f}, bound {limit:.3e})")
            if not (got.shape == (6, n) and torch.isfinite(got).all() and err <= limit):
                raise AssertionError(f"decode kernel disagrees with its plain version "
                                     f"({dtype}, N={n}): {err} > {limit}")

    # ---- 3. the inference slice ---------------------------------------------------------
    model.eval()
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
    primal_launches = dk.decode_primal_v4t.launches
    expected = 3 + 1 + 1 + 2  # 50,000 points decode in two chunks of at most 40,960
    log(f"[infer] decode kernel launches in the inference path: {primal_launches} (expected {expected})")
    if primal_launches != expected:
        raise AssertionError(f"inference launched the decode kernel {primal_launches} times, not {expected}")

    bounds = [cfg["obs_norm_cfg"][k].get("bound") for k in ("u10", "v10", "pres", "t2", "q2", "rio")]
    for h, g in grids.items():
        for i, (k, a) in enumerate(g.items()):
            if a.shape != (145, 257) or not np.isfinite(a).all():
                raise AssertionError(f"grid {k} at {h} h: shape {a.shape}, finite {np.isfinite(a).all()}")
            if i >= 2 and not (bounds[i][0] <= a.min() and a.max() <= bounds[i][1]):
                raise AssertionError(f"grid {k} at {h} h outside its clip bounds {bounds[i]}")
        log(f"[infer] grid at {h:4.1f} h: " + ", ".join(f"{k} {a.mean():.4g}" for k, a in g.items()))
    for q, p in zip(queries, points):
        if p.shape != (len(q[0]), 6) or not np.isfinite(p).all():
            raise AssertionError(f"points: shape {p.shape}")
        for i in range(2, 6):
            if not (bounds[i][0] <= p[:, i].min() and p[:, i].max() <= bounds[i][1]):
                raise AssertionError(f"points column {i} outside its clip bounds {bounds[i]}")
        log(f"[infer] {len(q[0])} points -> {p.shape}, mean T {p[:, 3].mean():.4g} K")

    # one frame through the plain decode, called explicitly
    fw, pe, cd_pe, ref_t = frame_inputs(6.5, cd)
    plain_norm = dk.decode_primal_v4t_ref(fw, pe, cd_pe, ref_t, cd)
    plain = inverse_norm_stack_t(plain_norm, dcfg.obs_specs, with_clip=True).cpu().numpy()
    stds = np.array([s.norm_factor[1] for s in dcfg.obs_specs])[:, None]
    frame = np.stack([grids[6.5][k].reshape(-1) for k in grids[6.5]])
    frame_err = float((np.abs(frame - plain) / stds).max())  # in normalized units
    limit = TOL[cd] * (1.0 + float(plain_norm.abs().max()))
    log(f"[infer] frame at 6.5 h against the plain decode: max error {frame_err:.3e} "
        f"normalized units (bound {limit:.3e})")
    if frame_err > limit:
        raise AssertionError(f"frame disagrees with the plain decode: {frame_err} > {limit}")
    model.train()

    # ---- v4s inputs of one flagship window (the training path's shapes) ---------------------
    def v4s_inputs(n: int, dtype):
        """Fused weights, trig operand, cd PE and reference values of the first n margin points."""
        with torch.no_grad():
            fh_norm = (batch.forecast_h / scfg.forecast_time_period)[:, None]
            tokens = model.encode(batch.field, fh_norm)[0]
            pts = batch.margin if n <= batch.margin.x.shape[1] else None
            if pts is None:  # the timing size: margin and collocation points together
                pts = ts.PointBatch(*(torch.cat([a, b], dim=1) for a, b in zip(batch.margin, batch.inter)))
            coords = torch.stack([pts.x[0, :n], pts.y[0, :n], pts.t[0, :n]], dim=-1)
            nwp = pts.nwp[0, :n]
            weights, pe_cm, cd_pe = engine._kernel_inputs_s(model, tokens, coords, nwp, fh_norm[0],
                                                            scfg.coord_spec)
            fw6 = dk.fuse_v6_from_v4(dk.fuse_decode_weights(weights), scfg.coord_spec)
        return fw6, pe_cm.to(dtype), cd_pe.to(dtype), nwp.t().contiguous()

    def cotangents(n: int, seed: int):
        g = np.random.RandomState(seed)
        return (torch.from_numpy(g.randn(n_vars, n).astype(np.float32)).to(dev),
                torch.from_numpy(g.randn(3, n_vars, n).astype(np.float32)).to(dev))

    def forward_check(what, dtype, n, p, t, p0, t0_, extra="", keep=None):
        """Hold a forward kernel's (primal, tangents) to its plain version's (var-major), at
        the points ``keep`` [N] bool when given; returns (max abs error, max error as a share
        of what each tolerance is stated in)."""
        ok = p.shape == (n_vars, n) and t.shape == (3, n_vars, n) and bool(
            torch.isfinite(p).all() and torch.isfinite(t).all())
        if keep is not None:
            p, t, p0, t0_ = p[:, keep], t[:, :, keep], p0[:, keep], t0_[:, :, keep]
        e_p, s_p = float((p - p0).abs().max()), float(p0.abs().max())
        lim_p = TOL[dtype] * (1.0 + s_p)
        ok = ok and e_p <= lim_p
        e_t = []
        for k in range(3):
            e, s_ = float((t[k] - t0_[k]).abs().max()), float(t0_[k].abs().max())
            e_t.append(e / s_)
            ok = ok and e <= TOL_TANGENT[dtype] * s_
        log(f"[{what}] {str(dtype):15s} N={n:6d}: primal max|kernel-plain| {e_p:.3e} (max|plain| "
            f"{s_p:.3f}, bound {lim_p:.3e}); tangents x, y, t relative to their largest: "
            + ", ".join(f"{e:.2e}" for e in e_t) + f" (bound {TOL_TANGENT[dtype]:.0e}){extra}")
        if not ok:
            raise AssertionError(f"{what} kernel disagrees with its plain version ({dtype}, N={n})")
        return max(e_p, float((t - t0_).abs().max())), max(e_p / (1.0 + s_p), *e_t)

    def backward_check(what, dtype, n, got, want, again, extra=""):
        """Hold a backward kernel's cotangents to its plain version's, per weight; ``again`` is
        a second run (or the other layout).  Returns (max abs error, worst relative error)."""
        rel, worst_abs, rerun = {}, 0.0, 0.0
        for name in got._fields:
            a_, b_ = getattr(got, name), getattr(want, name)
            scale = float(b_.abs().max())
            err = float((a_ - b_).abs().max())
            worst_abs = max(worst_abs, err)
            rel[name] = err / scale if scale > 0 else err
            rerun = max(rerun, float((getattr(again, name) - a_).abs().max()) / max(scale, 1e-30))
            if a_.shape != b_.shape or not torch.isfinite(a_).all() or err > RTOL_BWD[dtype] * scale:
                raise AssertionError(f"{what} kernel disagrees with its plain version "
                                     f"({dtype}, N={n}, {name}): {err} > {RTOL_BWD[dtype]} * {scale}")
        worst = max(rel, key=rel.get)
        log(f"[{what}] {str(dtype):15s} N={n:6d}: per weight max|kernel-plain| / max|plain| at most "
            f"{rel[worst]:.2e} ({worst}; bound {RTOL_BWD[dtype]:.0e}); two runs of the kernel "
            f"differ by {rerun:.1e} (atomic adds){extra}")
        return worst_abs, rel[worst]

    # ---- 4. v4s forward kernel against plain version -------------------------------------------
    fwd_err, fwd_rel, bwd_err, bwd_rel = {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in V4S_SIZES:
            fw6, pe_cm, cd_pe, ref_t = v4s_inputs(n, dtype)
            p, t = dk.fused_decode_jvp_v4s(fw6, pe_cm, cd_pe, ref_t, dtype)
            torch.cuda.synchronize()
            p0, t0_ = dk.decode_jvp_v4s_ref(fw6, pe_cm, cd_pe, ref_t, dtype)
            fwd_err[(dtype, n)], fwd_rel[(dtype, n)] = forward_check("forward", dtype, n, p, t, p0, t0_)

    # ---- 5. v4s backward kernel against plain version -------------------------------------------
    for dtype in (torch.bfloat16, torch.float32):
        for n in V4S_SIZES:
            fw6, pe_cm, cd_pe, _ = v4s_inputs(n, dtype)
            g_p, g_t = cotangents(n, seed=n)
            got = dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd_pe, g_p, g_t, dtype)
            again = dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd_pe, g_p, g_t, dtype)
            torch.cuda.synchronize()
            want = dk.decode_bwd_v4s_ref(fw6, pe_cm, cd_pe, g_p, g_t, dtype)
            bwd_err[(dtype, n)], bwd_rel[(dtype, n)] = backward_check("backward", dtype, n, got, want, again)

    # the autograd.Function against autograd of the plain forward, f32
    def function_check(what, weights, points, g_p, g_t, kernel_fn, plain_fn, forward, backward):
        """``kernel_fn(weights, *points)`` (an autograd.Function over the wrappers ``forward`` and
        ``backward``) against autograd of ``plain_fn``: the weights' cotangents, the reference
        values' (last of ``points``: the primal's cotangent itself) and zeros for the others."""
        def grads(fn):
            leaves = type(weights)(*(w.detach().clone().requires_grad_(True) for w in weights))
            pts = [x.detach().clone().requires_grad_(True) for x in points]
            p, t = fn(leaves, *pts)
            ((p * g_p).sum() + (t * g_t).sum()).backward()
            return leaves, pts

        counts = forward.launches, backward.launches
        w_k, pts_k = grads(kernel_fn)
        if (forward.launches, backward.launches) != (counts[0] + 1, counts[1] + 1):
            raise AssertionError(f"{what} did not launch one forward and one backward kernel")
        w_x, pts_x = grads(plain_fn)
        worst = 0.0
        for name, a_, b_ in zip(weights._fields, w_k, w_x):
            rel = float((a_.grad - b_.grad).abs().max()) / float(b_.grad.abs().max())
            worst = max(worst, rel)
            if rel > RTOL_BWD[torch.float32]:
                raise AssertionError(f"{what}: cotangent of {name} off by {rel}")
        if not torch.equal(pts_k[-1].grad, g_p):
            raise AssertionError(f"{what}: the cotangent of the reference values is not g_primal")
        if any(x.grad.any() for x in pts_k[:-1]) or not pts_x[0].grad.any():
            raise AssertionError(f"{what}: the cotangents of the point inputs must be zeros")
        log(f"[{what}] autograd.Function against autograd of the plain forward (f32, N={g_p.numel() // n_vars}): "
            f"weights within {worst:.2e} of their largest cotangent; g_ref = g_primal; point inputs zeros")

    f32 = torch.float32
    fw6, pe_cm, cd_pe, ref_t = v4s_inputs(1000, f32)
    function_check("backward", fw6, [pe_cm, cd_pe, ref_t], *cotangents(1000, seed=7),
                   lambda w, *pts: dk.fused_decode_jvp_v4s_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v4s_ref(w, *pts, f32),
                   dk.fused_decode_jvp_v4s, dk.decode_bwd_kernel_v4s)

    # ---- 6. the training slice ---------------------------------------------------------------------
    # one PDE step's loss and gradients under 'kernel' against 'jvp', from the seeded
    # starting state (before any update, so that every run compares the same state)
    def on_kernel_forward(plain_fn, kernel_fn):
        """``plain_fn``'s graph carrying ``kernel_fn``'s forward values to the last bit."""
        def fn(*args, **kwargs):
            p, t = plain_fn(*args, **kwargs)
            with torch.no_grad():
                p_k, t_k = kernel_fn(*args)
            return p_k + (p - p.detach()), t_k + (t - t.detach())
        return fn

    # per kernel_version: the engine's name for its plain forward, and the forward kernel
    # with the same positional arguments (the var-major layout, which the step runs)
    plain_forwards = {7: ("decode_jvp_v4s_ref", dk.fused_decode_jvp_v4s),
                      4: ("decode_jvp_v4_ref", dk.fused_decode_jvp_v4t),
                      6: ("decode_jvp_v6_ref", dk.fused_decode_jvp_v6)}  # [N, 6]: the only layout of 6

    def kernel_rounding_v6(fw, trig, cd_pe, ref, cdt, round_tangents=True):
        """The v6 plain forward as the kernel rounds: whatever the engine asks for."""
        return dk.decode_jvp_v6_ref(fw, trig.to(cdt), cd_pe.to(cdt), ref, cdt, round_tangents=True)

    def engine_gradients(model_, name, version=7):
        twin = copy.deepcopy(model_)
        attr, kernel_fn = plain_forwards[version]
        plain_forward = getattr(engine, attr)
        if name == "jvp twin":  # the step's own 'jvp' under kernel_version=6
            name = "jvp"
        elif version == 6 and name != "kernel":
            setattr(engine, attr, kernel_rounding_v6)
        if name == "jvp on kernel forward":
            setattr(engine, attr, on_kernel_forward(getattr(engine, attr), kernel_fn))
            name = "jvp"
        try:
            scfg_ = ts.step_config_from_cfg(cfg, pde_engine=name, kernel_version=version)
            total, _ = ts.make_loss_fn(twin, scfg_)(batch, True)
            total.backward()
        finally:
            setattr(engine, attr, plain_forward)
        grads = {k: p.grad.float() for k, p in twin.named_parameters()}
        norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
        return float(total.detach()), norm, grads

    def compare_engines(model_, label, rtol_norm, rtol_same_forward, version=7):
        """One PDE step's loss and gradients under 'kernel' against 'jvp' (see RTOL_STEP).
        Returns both engines' losses and gradients, the noise parameters and 'run to run'."""
        (l_k, n_k, g_k) = engine_gradients(model_, "kernel", version)
        (l_x, n_x, g_x) = engine_gradients(model_, "jvp", version)
        g_k2 = engine_gradients(model_, "kernel", version)[2]
        g_m = engine_gradients(model_, "jvp on kernel forward", version)[2]
        label = f"{label}, kernel_version={version}"
        largest = {k: float(g_x[k].abs().max()) for k in g_x}
        noise = [k for k in g_x if float((g_m[k] - g_x[k]).abs().max()) > NOISE_SHARE * largest[k]]
        noise_share = max(float(g[k].abs().max()) for g in (g_k, g_x) for k in noise) / n_x if noise else 0.0

        def worst(a, b):
            rel = {k: float((a[k] - b[k]).abs().max()) / largest[k] for k in a if k not in noise}
            top = sorted(rel, key=rel.get, reverse=True)[:3]
            return rel[top[0]], ", ".join(f"{k} {rel[k]:.1e}" for k in top)

        engines, same_forward = worst(g_k, g_x), worst(g_k, g_m)
        forward_alone, rerun = worst(g_m, g_x), worst(g_k, g_k2)
        rtol_grad = STEP_TIMES_EXPLAINED * max(forward_alone[0], rerun[0])
        if rtol_same_forward is None:
            rtol_same_forward = rtol_grad
        else:
            rtol_same_forward = max(rtol_same_forward, SAME_FORWARD_SHARE * forward_alone[0])
        log(f"[train] one PDE step, {label}, 'kernel' against 'jvp': total loss {l_k:.8g} / {l_x:.8g} "
            f"(relative {abs(l_k - l_x) / abs(l_x):.1e}, bound {RTOL_STEP_LOSS:.0e}); gradient norm "
            f"{n_k:.6g} / {n_x:.6g} (relative {abs(n_k - n_x) / n_x:.1e}, bound {rtol_norm:.0e}); per "
            f"parameter at most {engines[0]:.2e} of its largest gradient (bound {rtol_grad:.2e}, "
            f"{STEP_TIMES_EXPLAINED:.0f} x the larger of the next two; largest: {engines[1]}); forward alone "
            f"{forward_alone[0]:.2e} ({forward_alone[1]}); run to run {rerun[0]:.2e} ({rerun[1]}); same "
            f"forward {same_forward[0]:.2e} (bound {rtol_same_forward:.2e}; {same_forward[1]}); "
            f"{len(noise)} of {len(g_x)} parameters hold noise, at most {noise_share:.1e} of the gradient "
            f"norm (bound {ZERO_GRAD_NOISE:.0e}): " + ", ".join(noise[:8]))
        if not (abs(l_k - l_x) <= RTOL_STEP_LOSS * abs(l_x) and abs(n_k - n_x) <= rtol_norm * n_x
                and engines[0] <= rtol_grad and same_forward[0] <= rtol_same_forward
                and noise_share <= ZERO_GRAD_NOISE and np.isfinite(l_k) and np.isfinite(n_k)):
            raise AssertionError(f"one PDE step under 'kernel' disagrees with one under 'jvp' ({label})")
        return dict(loss_kernel=l_k, loss_jvp=l_x, kernel=g_k, jvp=g_x, noise=noise, rerun=rerun[0])

    def compare_versions(v4, v7, label, dtype, other=4, times=STEP_TIMES_EXPLAINED):
        """One PDE step under kernel_version=``other`` (``v4``) against kernel_version=7 (see
        RTOL_VERSIONS_LOSS); the gradients within ``times`` what explains their difference."""
        noise = set(v4["noise"]) | set(v7["noise"])
        largest = {k: float(g.abs().max()) for k, g in v7["jvp"].items()}

        def worst(a, b):
            rel = {k: float((a[k] - b[k]).abs().max()) / largest[k] for k in a if k not in noise}
            top = max(rel, key=rel.get)
            return rel[top], f"{top} {rel[top]:.1e}"

        kernels, plains = worst(v4["kernel"], v7["kernel"]), worst(v4["jvp"], v7["jvp"])
        rtol_grad = times * max(plains[0], v4["rerun"], v7["rerun"])
        loss_rel = abs(v4["loss_kernel"] - v7["loss_kernel"]) / abs(v7["loss_kernel"])
        log(f"[train v{other}] one PDE step, {label}, kernel_version={other} against 7 under 'kernel': total loss "
            f"{v4['loss_kernel']:.8g} / {v7['loss_kernel']:.8g} (relative {loss_rel:.1e}, bound "
            f"{RTOL_VERSIONS_LOSS[dtype]:.0e}); per parameter at most {kernels[0]:.2e} of its largest "
            f"gradient ({kernels[1]}; bound {rtol_grad:.2e}, {times:.0f} x the larger of: the "
            f"plain versions under 'jvp' {plains[0]:.2e} ({plains[1]}), run to run {v4['rerun']:.2e} and "
            f"{v7['rerun']:.2e})")
        if not (loss_rel <= RTOL_VERSIONS_LOSS[dtype] and kernels[0] <= rtol_grad):
            raise AssertionError(f"one PDE step under kernel_version={other} disagrees with 7 ({label})")

    def compare_twin(model_, label, dtype, loss_kernel):
        """The total loss of one kernel_version=6 PDE step under the step's own 'jvp' (the XLA
        twin's rounding) against 'kernel'."""
        l_twin, n_twin, _ = engine_gradients(model_, "jvp twin", 6)
        rel = abs(l_twin - loss_kernel) / abs(loss_kernel)
        log(f"[train v6] one PDE step, {label}, kernel_version=6, 'jvp' with the twin's rounding against "
            f"'kernel': total loss {l_twin:.8g} / {loss_kernel:.8g} (relative {rel:.1e}, bound "
            f"{RTOL_VERSIONS_LOSS[dtype]:.0e}); gradient norm {n_twin:.6g}")
        if not (np.isfinite(l_twin) and np.isfinite(n_twin) and rel <= RTOL_VERSIONS_LOSS[dtype]):
            raise AssertionError(f"kernel_version=6: 'jvp' disagrees with 'kernel' ({label})")

    def compare_linearize(model_, label, dtype, loss_jvp):
        """The total loss of one PDE step under 'linearize' against 'jvp'."""
        l_lin, n_lin, _ = engine_gradients(model_, "linearize")
        rel = abs(l_lin - loss_jvp) / abs(loss_jvp)
        log(f"[train v4] one PDE step, {label}, 'linearize' against 'jvp': total loss {l_lin:.8g} / "
            f"{loss_jvp:.8g} (relative {rel:.1e}, bound {RTOL_LINEARIZE_LOSS[dtype]:.0e}); gradient norm "
            f"{n_lin:.6g}")
        if not (np.isfinite(l_lin) and np.isfinite(n_lin) and rel <= RTOL_LINEARIZE_LOSS[dtype]):
            raise AssertionError(f"one PDE step under 'linearize' disagrees with 'jvp' ({label})")

    wrappers = (dk.decode_primal_v4t, dk.fused_decode_jvp_v4s, dk.decode_bwd_kernel_v4s, dk.fused_decode_jvp_v4,
                dk.fused_decode_jvp_v4t, dk.decode_bwd_kernel_v4, dk.decode_bwd_kernel_v4t,
                dk.fused_decode_jvp_v6, dk.decode_bwd_kernel_v6, rk.fused_residual_sums_v4,
                rk.fused_residual_sums_v6)

    def launch_counts():
        return {f.__name__: f.launches for f in wrappers}

    def reset_launch_counts():
        for f in wrappers:
            f.launches = 0

    # the seeded starting state serves the engine and version comparisons of phase 9 too
    counts = launch_counts()
    start = {(cd, 7): compare_engines(model, f"{cd} compute", *RTOL_STEP[cd])}
    start[(cd, 4)] = compare_engines(model, f"{cd} compute", *RTOL_STEP[cd], version=4)
    compare_versions(start[(cd, 4)], start[(cd, 7)], f"{cd} compute", cd)
    start[(cd, 6)] = compare_engines(model, f"{cd} compute", *RTOL_STEP[cd], version=6)
    compare_versions(start[(cd, 6)], start[(cd, 7)], f"{cd} compute", cd, other=6, times=NOISE_TIMES)
    compare_twin(model, f"{cd} compute", cd, start[(cd, 6)]["loss_kernel"])
    compare_linearize(model, f"{cd} compute", cd, start[(cd, 7)]["loss_jvp"])
    if cd != torch.float32:  # the same weights with float32 compute: no rounding to amplify
        f32 = torch.float32
        model32 = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                        torch.Generator().manual_seed(0), compute_dtype=f32,
                                        device=dev).model
        start[(f32, 7)] = compare_engines(model32, "float32 compute", *RTOL_STEP[f32])
        start[(f32, 4)] = compare_engines(model32, "float32 compute", *RTOL_STEP[f32], version=4)
        compare_versions(start[(f32, 4)], start[(f32, 7)], "float32 compute", f32)
        start[(f32, 6)] = compare_engines(model32, "float32 compute", *RTOL_STEP[f32], version=6)
        compare_versions(start[(f32, 6)], start[(f32, 7)], "float32 compute", f32, other=6, times=NOISE_TIMES)
        compare_twin(model32, "float32 compute", f32, start[(f32, 6)]["loss_kernel"])
        compare_linearize(model32, "float32 compute", f32, start[(f32, 7)]["loss_jvp"])
        del model32
    if any(launch_counts()[k] == counts[k] for k in (
            "fused_decode_jvp_v4s", "decode_bwd_kernel_v4s", "fused_decode_jvp_v4t", "decode_bwd_kernel_v4t",
            "fused_decode_jvp_v6", "decode_bwd_kernel_v6")):
        raise AssertionError("the 'kernel' engine launched no kernel")
    del start
    state4 = copy.deepcopy(state)  # the seeded state, before any update: phase 9 steps from it
    state6 = copy.deepcopy(state)  # and phase 12
    torch.cuda.empty_cache()

    step = ts.make_train_step(scfg)
    before = [p.detach().clone() for p in model.parameters()]
    dk.fused_decode_jvp_v4s.launches = dk.decode_bwd_kernel_v4s.launches = 0
    history = []
    for i in range(6):
        with_pde = i >= 3
        counts = dk.fused_decode_jvp_v4s.launches, dk.decode_bwd_kernel_v4s.launches
        state, metrics = step(state, batch, with_pde)
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        launched = (dk.fused_decode_jvp_v4s.launches - counts[0], dk.decode_bwd_kernel_v4s.launches - counts[1])
        log(f"[train] step {i} ({'pde' if with_pde else 'data-only'}): total {metrics['total_loss']:.6g}, "
            f"margin {metrics['margin_loss']:.6g}, grad_norm {metrics['grad_norm']:.6g}, forward / backward "
            f"kernel launches {launched[0]} / {launched[1]}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad or metrics["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"train step {i}: non-finite metrics {bad}, skipped {metrics['skipped_nonfinite']}")
        if launched != ((2, 2) if with_pde else (0, 0)):
            raise AssertionError(f"train step {i} launched the kernels {launched} times")
    fwd_launches, bwd_launches = dk.fused_decode_jvp_v4s.launches, dk.decode_bwd_kernel_v4s.launches
    log(f"[train] kernel launches in the training path: forward {fwd_launches}, backward {bwd_launches} "
        f"(expected 6 and 6); PDE metrics: " + ", ".join(
            f"{k} {history[-1][k]:.4g}" for k in ("inter_total", "margin_total", "margin_vapor_loss", "inter_gas_loss")))
    if (fwd_launches, bwd_launches) != (6, 6) or state.step != 6:
        raise AssertionError("the training path did not go through the kernels as expected")
    if not all(bool((a != b).any()) for a, b in zip(before, model.parameters())):
        raise AssertionError("a parameter did not change in six training steps")
    if not history[2]["margin_loss"] < history[0]["margin_loss"]:
        raise AssertionError("the data loss did not fall over three data-only steps on one batch")

    # ---- 7. the v4 pair against its plain version, both layouts ------------------------------------
    def v4_case(frame, n):
        """The first n points of a frame's v4 inputs: var-major and point-major reference values."""
        fw, pe, dpe, cd_pe, ref_t = frame
        ref_t = ref_t[:, :n].contiguous()
        return (fw, pe[:n].contiguous(), dpe[:, :n].contiguous(), cd_pe[:n].contiguous()), ref_t, ref_t.t().contiguous()

    def near_kink(fw, pe, w1, cd_pe, dtype):
        """[N] bool: the points with a relu argument of the plain version near zero (KINK_EPS);
        ``pe`` [N, in_ch] and ``w1`` [6, in_ch, hid] are the primal operand and its layer-1 rows."""
        z = dk.dot_f32(pe, w1, dtype) + fw.b1[:, None, :]  # [6, N, hid]
        near = (z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
        r = (dk.dot_f32(torch.relu(z), fw.w2f1, dtype) + dk.dot_f32(cd_pe, fw.wdf1, dtype)
             + fw.rbias[:, None, :])
        return near | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0)

    v4_fwd_err, v4_fwd_rel, v4_bwd_err, v4_bwd_rel = {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        frame = frame_inputs(6.5, dtype, with_tangents=True)
        for n in V4_SIZES:
            ins, ref_t, ref_n = v4_case(frame, n)
            near = near_kink(ins[0], ins[1], ins[0].w1, ins[3], dtype)
            left_out = f"; {int(near.sum())} of {n} points near a relu's kink left out"
            if int(near.sum()) > max(1, KINK_SHARE * n):  # at 3 points one near a kink is a 10% event
                raise AssertionError(f"v4 checks: {left_out} ({dtype})")
            p_t, t_t = dk.fused_decode_jvp_v4t(*ins, ref_t, dtype)
            p_n, t_n = dk.fused_decode_jvp_v4(*ins, ref_n, dtype)
            torch.cuda.synchronize()
            if p_n.shape != (n, n_vars) or t_n.shape != (3, n, n_vars):
                raise AssertionError(f"v4 forward, [N, 6] layout: shapes {p_n.shape}, {t_n.shape}")
            if not (torch.equal(p_n.t(), p_t) and torch.equal(t_n.transpose(1, 2), t_t)):
                raise AssertionError(f"v4 forward: the two layouts differ in their bits ({dtype}, N={n})")
            p0, t0_ = dk.decode_jvp_v4_ref(*ins, ref_t, dtype, t_layout=True)
            checked = forward_check("v4 forward", dtype, n, p_t, t_t, p0, t0_,
                                    "; [N, 6] layout bit-equal to [6, N]" + left_out, keep=~near)
            for t_layout in (True, False):  # bit-equal, so one reading serves both
                v4_fwd_err[(t_layout, dtype, n)], v4_fwd_rel[(t_layout, dtype, n)] = checked
            del p0, t0_

            g_p, g_t = cotangents(n, seed=n + 1)
            g_p[:, near], g_t[:, :, near] = 0.0, 0.0
            got = dk.decode_bwd_kernel_v4t(*ins, g_p, g_t, dtype)
            again = dk.decode_bwd_kernel_v4t(*ins, g_p, g_t, dtype)
            got_n = dk.decode_bwd_kernel_v4(*ins, g_p.t().contiguous(), g_t.transpose(1, 2).contiguous(), dtype)
            torch.cuda.synchronize()
            want = dk.decode_bwd_v4_ref(*ins, g_p, g_t, dtype, t_layout=True)
            v4_bwd_err[(True, dtype, n)], v4_bwd_rel[(True, dtype, n)] = backward_check(
                "v4 backward [6, N]", dtype, n, got, want, again)
            v4_bwd_err[(False, dtype, n)], v4_bwd_rel[(False, dtype, n)] = backward_check(
                "v4 backward [N, 6]", dtype, n, got_n, want, got, " (here: the two layouts)")
            del got, again, got_n, want
        del frame
    torch.cuda.empty_cache()

    ins, ref_t, ref_n = v4_case(frame_inputs(6.5, f32, with_tangents=True), 1000)
    g_p, g_t = cotangents(1000, seed=8)
    function_check("v4 backward [6, N]", ins[0], [*ins[1:], ref_t], g_p, g_t,
                   lambda w, *pts: dk.fused_decode_jvp_v4t_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v4_ref(w, *pts, f32, t_layout=True),
                   dk.fused_decode_jvp_v4t, dk.decode_bwd_kernel_v4t)
    function_check("v4 backward [N, 6]", ins[0], [*ins[1:], ref_n], g_p.t().contiguous(),
                   g_t.transpose(1, 2).contiguous(),
                   lambda w, *pts: dk.fused_decode_jvp_v4_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v4_ref(w, *pts, f32),
                   dk.fused_decode_jvp_v4, dk.decode_bwd_kernel_v4)

    # ---- 8. the evaluation sweeps ---------------------------------------------------------------------
    model.eval()
    reset_launch_counts()
    residuals = evaluate_residuals(model, scfg, [window])
    maps = residual_field_maps(model, scfg, [window], window=0, hour=7)
    rmse = evaluate_rmse_fullgrid(model, scfg, [window], per_lead=True)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    n_hours = window.n_label_hours
    expected = dict.fromkeys(eval_launches, 0)
    expected.update(fused_decode_jvp_v4t=n_hours, fused_decode_jvp_v4=1, decode_primal_v4t=n_hours)
    log(f"[eval] kernel launches in the evaluation path: {eval_launches} (expected {n_hours} v4t forward, "
        f"1 [N, 6] forward, {n_hours} primal)")
    if eval_launches != expected or n_hours != 25:
        raise AssertionError(f"the evaluation path launched {eval_launches}, not {expected}")
    bad = [k for k, v in {**residuals, **rmse}.items() if not np.isfinite(v)]
    bad += [k for k, m in maps.items() if m.shape != (145, 257) or not np.isfinite(m).all()]
    if bad or len(maps) != 6 or rmse["n_points"] != float(n_hours * GRID_POINTS) or \
            residuals["n_points_per_hour"] != float(GRID_POINTS) or "rmse_t2_f048" not in rmse:
        raise AssertionError(f"the evaluation sweeps returned non-finite or misshapen results: {bad}")
    log("[eval] residual MSE per equation: " + ", ".join(
        f"{k[len('residual_mse_'):]} {v:.4g}" for k, v in residuals.items() if k.startswith("residual_mse_"))
        + f"; weighted total {residuals['weighted_total']:.6g}")
    log("[eval] full-grid RMSE: " + ", ".join(f"{k[5:]} {v:.4g}" for k, v in rmse.items()
                                              if k.startswith("rmse_") and "_f" not in k)
        + f" over {rmse['n_points']:.0f} points; largest squared residual of the maps at hour 7: "
        + ", ".join(f"{k} {m.max():.3g}" for k, m in maps.items()))

    # the residual sweep again on the plain version of the forward kernel
    kernel_forward = engine.fused_decode_jvp_v4t
    engine.fused_decode_jvp_v4t = lambda *a: dk.decode_jvp_v4_ref(*a, t_layout=True)
    try:
        residuals_plain = evaluate_residuals(model, scfg, [window])
    finally:
        engine.fused_decode_jvp_v4t = kernel_forward
    if launch_counts() != eval_launches:
        raise AssertionError("the plain residual sweep launched a kernel")
    sweep_rel = {k: abs(v - residuals_plain[k]) / max(abs(residuals_plain[k]), 1e-300) for k, v in residuals.items()}
    worst = max(sweep_rel, key=sweep_rel.get)
    log(f"[eval] residual sweep through the kernel against the plain version: at most {sweep_rel[worst]:.2e} "
        f"relative ({worst}; bound {RTOL_SWEEP:.0e})")
    if not sweep_rel[worst] <= RTOL_SWEEP:
        raise AssertionError(f"the residual sweep disagrees with the plain version: {sweep_rel}")
    model.train()

    # ---- 9. the training step under kernel_version=4 and 'linearize' -------------------------------
    # (the engine, version and 'linearize' comparisons of one PDE step ran in phase 6, at the seeded state)
    reset_launch_counts()
    v4_steps = [("kernel_version=4", dict(kernel_version=4), {"fused_decode_jvp_v4t": 2, "decode_bwd_kernel_v4t": 2})] * 3
    v4_steps.append(("kernel_version=4, var_major off", dict(kernel_version=4, var_major=False),
                     {"fused_decode_jvp_v4": 2, "decode_bwd_kernel_v4": 2}))
    v4_steps.append(("'linearize'", dict(pde_engine="linearize"), {}))
    before = [p.detach().clone() for p in state4.model.parameters()]
    for i, (label, overrides, want) in enumerate(v4_steps):
        counts = launch_counts()
        state4, metrics = ts.make_train_step(ts.step_config_from_cfg(cfg, **overrides))(state4, batch, True)
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        launched = {k: v - counts[k] for k, v in launch_counts().items() if v != counts[k]}
        log(f"[train v4] step {i} (pde, {label}): total {metrics['total_loss']:.6g}, margin "
            f"{metrics['margin_loss']:.6g}, grad_norm {metrics['grad_norm']:.6g}, kernel launches {launched}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad or metrics["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"train step ({label}): non-finite metrics {bad}, skipped {metrics['skipped_nonfinite']}")
        if launched != want:
            raise AssertionError(f"train step ({label}) launched {launched}, not {want}")
    train4_launches = launch_counts()
    log(f"[train v4] kernel launches in the kernel_version=4 training path: {train4_launches}")
    if state4.step != 5 or not all(bool((a_ != b_).any()) for a_, b_ in zip(before, state4.model.parameters())):
        raise AssertionError("a parameter did not change in the kernel_version=4 steps")
    del state4, before
    torch.cuda.empty_cache()

    # ---- 10. the v6 pair against its plain version -------------------------------------------------
    def v6_inputs(n: int, dtype):
        """The v4s inputs of the first n points with the operand laid out by direction
        ([3, N, 2F]) and the reference values point-major ([N, 6]); the v4s operands too."""
        fw6, pe_cm, cd_pe, ref_t = v4s_inputs(n, dtype)
        trig = pe_cm.reshape(n, 3, -1).permute(1, 0, 2).contiguous()
        return fw6, trig, cd_pe, ref_t.t().contiguous(), pe_cm, ref_t

    def point_major(g_p, g_t):
        return g_p.t().contiguous(), g_t.transpose(1, 2).contiguous()

    v6_fwd_err, v6_fwd_rel, v6_bwd_err, v6_bwd_rel = {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in V4S_SIZES:
            fw6, trig, cd_pe, ref, pe_cm, ref_t = v6_inputs(n, dtype)
            p, t = dk.fused_decode_jvp_v6(fw6, trig, cd_pe, ref, dtype)
            p_s, t_s = dk.fused_decode_jvp_v4s(fw6, pe_cm, cd_pe, ref_t, dtype)
            torch.cuda.synchronize()
            if p.shape != (n, n_vars) or t.shape != (3, n, n_vars):
                raise AssertionError(f"v6 forward: shapes {p.shape}, {t.shape}")
            if not (torch.equal(p.t(), p_s) and torch.equal(t.transpose(1, 2), t_s)):
                raise AssertionError(f"v6 forward: differs from the v4s kernel in its bits ({dtype}, N={n})")
            p0, t0_ = dk.decode_jvp_v6_ref(fw6, trig, cd_pe, ref, dtype)
            # by now the model has taken training steps whose atomic adds differ from run to
            # run, so which points lie on a relu's kink does too: left out as in the v4 checks
            near = near_kink(fw6, pe_cm, fw6.w1g.reshape(n_vars, -1, fw6.w1g.shape[-1]), cd_pe, dtype)
            if int(near.sum()) > max(1, KINK_SHARE * n):
                raise AssertionError(f"v6 checks: {int(near.sum())} of {n} points near a relu's kink ({dtype})")
            v6_fwd_err[(dtype, n)], v6_fwd_rel[(dtype, n)] = forward_check(
                "v6 forward", dtype, n, p.t(), t.transpose(1, 2), p0.t(), t0_.transpose(1, 2),
                f"; bit-equal to the v4s kernel on the same points; {int(near.sum())} of {n} points near a "
                "relu's kink left out", keep=~near)
            g_p, g_t = cotangents(n, seed=n + 2)
            g_p[:, near], g_t[:, :, near] = 0.0, 0.0
            g_p, g_t = point_major(g_p, g_t)
            got = dk.decode_bwd_kernel_v6(fw6, trig, cd_pe, g_p, g_t, dtype)
            again = dk.decode_bwd_kernel_v6(fw6, trig, cd_pe, g_p, g_t, dtype)
            torch.cuda.synchronize()
            want = dk.decode_bwd_v6_ref(fw6, trig, cd_pe, g_p, g_t, dtype)
            v6_bwd_err[(dtype, n)], v6_bwd_rel[(dtype, n)] = backward_check("v6 backward", dtype, n, got, want, again)
            del p0, t0_, got, again, want
    fw6, trig, cd_pe, ref, _, _ = v6_inputs(1000, f32)
    function_check("v6 backward", fw6, [trig, cd_pe, ref], *point_major(*cotangents(1000, seed=9)),
                   lambda w, *pts: dk.fused_decode_jvp_v6_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v6_ref(w, *pts, f32),
                   dk.fused_decode_jvp_v6, dk.decode_bwd_kernel_v6)
    del fw6, trig, cd_pe, ref
    torch.cuda.empty_cache()

    # ---- 11. the residual-sum kernels: decode and PDE assembly in one launch ----------------------
    model.eval()
    unit = {k: 1.0 for k in scfg.loss_factor}
    LOSS_KEYS = ("montion_u_loss", "montion_v_loss", "continous_loss", "energy_loss", "vapor_loss", "gas_loss")

    def window_points(n: int, seed: int):
        """n seeded points of the window, anywhere on the fine grid and in the 24 hours:
        coordinates [N, 3], conditioning values [N, 6] and Coriolis parameter [N, 1]."""
        g = np.random.RandomState(seed)
        px, py, pt, nwp, cor = window.get_margin_grid(g.rand(n) * 256.0, g.rand(n) * 144.0, g.rand(n) * 24.0)
        return (torch.from_numpy(np.stack([px, py, pt], -1)).to(dev), torch.from_numpy(nwp).to(dev),
                torch.from_numpy(cor).to(dev))

    fh_norm_w = window.forecast_h / dcfg.forecast_time_period
    tokens_w = runner._encode(model, field, fh_norm_w)
    fh_w = torch.tensor([fh_norm_w], device=dev)

    def residual_inputs(version: int, coords, nwp, dtype):
        """The residual-sum wrapper's arguments up to the conditioning values."""
        with torch.no_grad():
            if version == 6:
                fw6, trig, cd_pe = engine._kernel_inputs_6(model, tokens_w, coords, nwp, fh_w, scfg.coord_spec)
                return fw6, trig.to(dtype), cd_pe.to(dtype), nwp
            weights, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens_w, coords, nwp, fh_w, scfg.coord_spec)
            return dk.fuse_decode_weights(weights), pe.to(dtype), dpe.to(dtype), cd_pe.to(dtype), nwp

    def vapor_switch_points(primal, tang, cor, with_clip, eps):
        """Of the plain decode's points: how many lie within eps of a switch of the vapor
        equation's delta (Dp/Dt = 0, q = q_s), and the most their squared terms can move."""
        P, D = engine.packed_physical_from_primal_tangents(primal, tang, scfg.obs_specs, with_clip)
        u, v, p, T, q = P[0], P[1], P[2], P[3], P[4]
        dp = D[2, 2] + u * D[0, 2] + v * D[1, 2]
        dq = D[2, 4] + u * D[0, 4] + v * D[1, 4]
        c = scfg.constants
        q_s = torch.clamp(engine.saturation_specific_humidity_packed(p, T), min=1e-6)
        # exact ties are safe: a clipped p has Dp/Dt = 0 and a clipped q equals the floor of q_s
        # on both sides, to the bit
        near = ((dp != 0) & (dp.abs() < eps * dp.abs().max())) | ((q != q_s) & ((q - q_s).abs() < eps * q_s))
        f_fac = (c.latent_heat * (1.0 + 0.608 * q) * c.r_d - c.c_p * c.r_v * T) / (
            c.c_p * c.r_v + T * T + c.latent_heat**2 * q_s) * q_s * T
        on = -dp * f_fac / (p + c.eps_rho) + dq
        return int(near.sum()), float(torch.maximum(on * on, dq * dq)[near].double().sum())

    resid_err, resid_rel, switch_moved = {}, {}, {}
    residual_fns = {4: (rk.fused_residual_sums_v4, rk.residual_sums_v4_ref, dk.decode_jvp_v4_ref),
                    6: (rk.fused_residual_sums_v6, rk.residual_sums_v6_ref, dk.decode_jvp_v6_ref)}
    for n in RESIDUAL_SIZES:
        coords, nwp, cor = window_points(n, seed=n)
        for version, (kernel_fn, plain_fn, decode_ref) in residual_fns.items():
            for dtype in (torch.bfloat16, torch.float32):
                all_ins = residual_inputs(version, coords, nwp, dtype)
                for with_clip in (True, False):
                    # Without the clip a model of random weights gives unphysical fields, and the
                    # Tetens formula is singular at T = 29.65 K and overflows below it: there the
                    # vapor term is inf / inf, and near it it amplifies the decode's last bits.
                    # So the no-clip runs leave out the points whose plain p or T lies outside its
                    # physical bounds (u, v, q and rho stay as wild as they come) or whose terms
                    # are not finite; the rest is a ragged size of its own.
                    ins, cor_, dropped = all_ins, cor, 0
                    primal, tang = decode_ref(*ins, dtype)
                    keep = torch.isfinite(rk.residual_point_terms(primal, tang, cor, scfg.obs_specs, with_clip)).all(0)
                    if not with_clip:
                        for v_ in (2, 3):
                            spec = scfg.obs_specs[v_]
                            phys = primal[:, v_] * spec.norm_factor[1] + spec.norm_factor[0]
                            keep &= (phys > spec.bound[0]) & (phys < spec.bound[1])
                    if not bool(keep.all()):
                        dropped, cor_ = int((~keep).sum()), cor[keep].contiguous()
                        ins = (ins[0], *(x[:, keep].contiguous() if x.ndim == 3 else x[keep].contiguous()
                                         for x in ins[1:]))
                        primal, tang = decode_ref(*ins, dtype)
                    got = kernel_fn(*ins, cor_, scfg.obs_specs, with_clip=with_clip, compute_dtype=dtype)
                    again = kernel_fn(*ins, cor_, scfg.obs_specs, with_clip=with_clip, compute_dtype=dtype)
                    torch.cuda.synchronize()
                    want = plain_fn(*ins, cor_, scfg.obs_specs, with_clip=with_clip, compute_dtype=dtype)
                    exact = rk.residual_point_terms(primal, tang, cor_, scfg.obs_specs, with_clip).double().sum(1)
                    rel = ((got - want).abs() / want.abs()).tolist()
                    n_near, moved = vapor_switch_points(primal, tang, cor_, with_clip, SWITCH_EPS[dtype])
                    switch_moved[(version, dtype, with_clip)] = moved
                    limits = [RTOL_RESIDUAL[dtype]] * 6
                    limits[4] += moved / float(want[4])
                    worst = max(range(6), key=lambda e: rel[e] / limits[e])
                    log(f"[residual] v{version} {str(dtype):15s} N={n:6d} clip={with_clip!s:5s}: per equation "
                        f"|kernel-plain| / plain at most {rel[worst]:.2e} ({rk.EQUATIONS[worst]}; bound "
                        f"{limits[worst]:.1e}); two runs bit-equal: {torch.equal(got, again)}; kernel "
                        + " ".join(f"{x:.8g}" for x in got.tolist()) + "; plain "
                        + " ".join(f"{x:.8g}" for x in want.tolist()) + "; float64 sum of the plain terms "
                        + " ".join(f"{x:.8g}" for x in exact.tolist())
                        + f"; {n_near} points within {SWITCH_EPS[dtype]:.0e} of a switch of delta, their vapor "
                        f"terms at most {moved:.3g}; {dropped} points left out")
                    if not (got.shape == (6,) and bool(torch.isfinite(got).all()) and torch.equal(got, again)
                            and all(r_ <= l_ for r_, l_ in zip(rel, limits))):
                        raise AssertionError(f"residual-sum kernel v{version} disagrees with its plain version "
                                             f"({dtype}, N={n}, with_clip={with_clip}): {rel} > {limits}")
                    if with_clip:
                        resid_err[(version, dtype, n)] = float((got - want).abs().max())
                        resid_rel[(version, dtype, n)] = rel[worst]
                del primal, tang, ins, all_ins
        # the in-kernel path against the split path on the same points, through the entry points
        args = (model, tokens_w, coords, nwp, fh_w, cor, scfg.coord_spec, scfg.obs_specs, unit)
        crossover = engine.FUSED_ASSEMBLY_MIN_N
        engine.FUSED_ASSEMBLY_MIN_N = 10**9  # version 6: the split branch at any size
        try:
            split = {4: engine.fused_residual_losses(*args, version=4),
                     6: engine.fused_residual_losses(*args, version=6)}
        finally:
            engine.FUSED_ASSEMBLY_MIN_N = crossover
        for version in (4, 6):
            fused = rk.kernel_residual_losses(*args, version=version)
            want = {k: float(split[version][k]) for k in LOSS_KEYS}
            rel = {k: abs(float(fused[k]) - w_) / abs(w_) for k, w_ in want.items()}
            worst = max(rel, key=rel.get)
            log(f"[residual] v{version} {cd} N={n:6d}: in-kernel assembly against the split path, per loss at most "
                f"{rel[worst]:.2e} ({worst}; bound {RTOL_RESIDUAL[cd]:.0e}, vapor as above)")
            vapor_limit = RTOL_RESIDUAL[cd] + switch_moved[(version, cd, True)] / (
                want["vapor_loss"] * n)  # with unit factors a loss is its equation's sum over n
            if not all(r_ <= RTOL_RESIDUAL[cd] for k, r_ in rel.items() if k != "vapor_loss") or \
                    not rel["vapor_loss"] <= vapor_limit:
                raise AssertionError(f"in-kernel assembly v{version} disagrees with the split path (N={n}): {rel}")
    del coords, nwp, cor, args
    torch.cuda.empty_cache()

    # the entry points on both sides of the crossover, from counts of 0
    reset_launch_counts()
    entry = {}
    for label, fn, version, n in (
            ("fused_residual_losses(version=6), split branch", engine.fused_residual_losses, 6, RESIDUAL_SPLIT_N),
            ("fused_residual_losses(version=6), in-kernel", engine.fused_residual_losses, 6, RESIDUAL_MAIN_N),
            ("kernel_residual_losses(version=4)", rk.kernel_residual_losses, 4, RESIDUAL_MAIN_N)):
        coords, nwp, cor = window_points(n, seed=n + 1)
        entry[label] = fn(model, tokens_w, coords, nwp, fh_w, cor, scfg.coord_spec, scfg.obs_specs,
                          scfg.factors(), version=version)
        torch.cuda.synchronize()
        bad = [k for k, v in entry[label].items() if not np.isfinite(float(v))]
        log(f"[residual] {label} at N={n}: total {float(entry[label]['total']):.6g}, vapor "
            f"{float(entry[label]['vapor_loss']):.4g}, gas {float(entry[label]['gas_loss']):.4g}")
        if bad or len(entry[label]) != 7:
            raise AssertionError(f"{label}: non-finite or missing losses {bad}")
    resid_launches = launch_counts()
    expected = dict.fromkeys(resid_launches, 0)
    expected.update(fused_decode_jvp_v6=1, fused_residual_sums_v6=1, fused_residual_sums_v4=1)
    log(f"[residual] kernel launches of the residual entry points: {resid_launches} (expected one v6 forward "
        f"below {engine.FUSED_ASSEMBLY_MIN_N} points, one in-kernel launch of each version above)")
    if resid_launches != expected or not RESIDUAL_SPLIT_N < engine.FUSED_ASSEMBLY_MIN_N <= RESIDUAL_MAIN_N:
        raise AssertionError(f"the residual entry points launched {resid_launches}, not {expected}")
    model.train()

    # ---- 12. the training step under kernel_version=6 ---------------------------------------------
    # (the engine and version comparisons of one PDE step ran in phase 6, at the seeded state)
    reset_launch_counts()
    step6 = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=6))
    before = [p.detach().clone() for p in state6.model.parameters()]
    for i in range(3):
        counts = launch_counts()
        state6, metrics = step6(state6, batch, True)
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        launched = {k: v - counts[k] for k, v in launch_counts().items() if v != counts[k]}
        log(f"[train v6] step {i} (pde, kernel_version=6): total {metrics['total_loss']:.6g}, margin "
            f"{metrics['margin_loss']:.6g}, grad_norm {metrics['grad_norm']:.6g}, kernel launches {launched}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad or metrics["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"train step (kernel_version=6): non-finite metrics {bad}")
        if launched != {"fused_decode_jvp_v6": 2, "decode_bwd_kernel_v6": 2}:
            raise AssertionError(f"train step (kernel_version=6) launched {launched}")
    train6_launches = launch_counts()
    if state6.step != 3 or not all(bool((a_ != b_).any()) for a_, b_ in zip(before, state6.model.parameters())):
        raise AssertionError("a parameter did not change in the kernel_version=6 steps")
    del state6, before
    torch.cuda.empty_cache()

    # ---- 13. timing --------------------------------------------------------------------------------
    hid, in_ch = cfg["net_cfg"]["hidden_channels"], cfg["net_cfg"]["in_channels"]
    two_f = in_ch // 3

    fw, pe, cd_pe, ref_t = frame_inputs(6.5, cd)
    k_ms, p_ms, times = alternating_ms(lambda: dk.decode_primal_v4t(fw, pe, cd_pe, ref_t, cd),
                                       lambda: dk.decode_primal_v4t_ref(fw, pe, cd_pe, ref_t, cd), 10)
    primal_flops = 2.0 * n_vars * (in_ch * hid + hid * hid + in_ch * hid) * GRID_POINTS
    primal_out = torch.empty((n_vars, GRID_POINTS), device=dev)
    primal_bound = bound(primal_flops, tensor_bytes(pe, cd_pe, ref_t, primal_out, *(
        w.to(cd) if w.ndim == 3 else w for w in fw)))
    log(f"[timing] primal decode at N={GRID_POINTS} {cd}: kernel {k_ms:.4f} ms "
        f"({primal_flops / k_ms / 1e9:.2f} TFLOP/s), plain {p_ms:.4f} ms, bound {primal_bound[0]:.4f} ms "
        f"({primal_bound[1]}); runs kernel {[round(t, 4) for t in times['kernel']]} "
        f"plain {[round(t, 4) for t in times['plain']]}")

    fwd_macs = in_ch * hid + 3 * two_f * hid + hid * hid + in_ch * hid + 3 * hid * hid  # per point and variable
    bwd_macs = fwd_macs + (4 * hid * hid + in_ch * hid) + 4 * hid * hid + (in_ch * hid + 3 * two_f * hid)
    v4s_ms = {}
    for n in (TIMING_POINTS, 20480, 4096):
        fw6, pe_cm, cd_pe6, ref6 = v4s_inputs(n, cd)
        g_p, g_t = cotangents(n, seed=3)
        f_ms, fp_ms, f_times = alternating_ms(
            lambda: dk.fused_decode_jvp_v4s(fw6, pe_cm, cd_pe6, ref6, cd),
            lambda: dk.decode_jvp_v4s_ref(fw6, pe_cm, cd_pe6, ref6, cd), 5)
        b_ms, bp_ms, b_times = alternating_ms(
            lambda: dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd_pe6, g_p, g_t, cd),
            lambda: dk.decode_bwd_v4s_ref(fw6, pe_cm, cd_pe6, g_p, g_t, cd), 5)
        matrices = [w.to(cd) if w.ndim >= 3 else w for w in fw6]
        f_bound = bound(2.0 * n_vars * fwd_macs * n, tensor_bytes(
            pe_cm, cd_pe6, ref6, *matrices) + 4 * (n_vars * n + 3 * n_vars * n))
        b_bound = bound(2.0 * n_vars * bwd_macs * n, tensor_bytes(
            pe_cm, cd_pe6, g_p, g_t, *matrices[:-1]) + 4 * sum(w.numel() for w in fw6[:-1]))
        v4s_ms[n] = dict(fwd=f_ms, fwd_plain=fp_ms, bwd=b_ms, bwd_plain=bp_ms, fwd_bound=f_bound, bwd_bound=b_bound)
        log(f"[timing] v4s at N={n} {cd}: forward kernel {f_ms:.4f} ms ({2e-9 * n_vars * fwd_macs * n / f_ms:.2f} "
            f"TFLOP/s), plain {fp_ms:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]}); backward kernel "
            f"{b_ms:.4f} ms ({2e-9 * n_vars * bwd_macs * n / b_ms:.2f} TFLOP/s), plain {bp_ms:.4f} ms, bound "
            f"{b_bound[0]:.4f} ms ({b_bound[1]}); runs fwd {[round(t, 3) for t in f_times['kernel']]} "
            f"bwd {[round(t, 3) for t in b_times['kernel']]}")
    del fw6, pe_cm, cd_pe6, ref6, g_p, g_t

    # the v4 pair in both layouts, at one evaluation frame and at the step's larger launch;
    # the same operations per point as v4s (two_f = in_ch / 3 lanes per tangent direction)
    v4_ms = {}
    frame = frame_inputs(6.5, cd, with_tangents=True)
    for n in (GRID_POINTS, 20480):
        ins, ref_t, ref_n = v4_case(frame, n)
        g_p, g_t = cotangents(n, seed=3)
        matrices = [w.to(cd) if w.ndim >= 3 else w for w in ins[0]]
        f_bound = bound(2.0 * n_vars * fwd_macs * n, tensor_bytes(
            *ins[1:], ref_t, *matrices) + 4 * (n_vars * n + 3 * n_vars * n))
        b_bound = bound(2.0 * n_vars * bwd_macs * n, tensor_bytes(
            *ins[1:], g_p, g_t, *matrices[:-1]) + 4 * sum(w.numel() for w in ins[0][:-1]))
        for layout, t_layout, fwd, bwd, ref, gp, gt in (
                ("[6, N]", True, dk.fused_decode_jvp_v4t, dk.decode_bwd_kernel_v4t, ref_t, g_p, g_t),
                ("[N, 6]", False, dk.fused_decode_jvp_v4, dk.decode_bwd_kernel_v4, ref_n,
                 g_p.t().contiguous(), g_t.transpose(1, 2).contiguous())):
            f_ms, fp_ms, f_times = alternating_ms(
                lambda: fwd(*ins, ref, cd),
                lambda: dk.decode_jvp_v4_ref(*ins, ref, cd, t_layout=t_layout), 5)
            b_ms, bp_ms, b_times = alternating_ms(
                lambda: bwd(*ins, gp, gt, cd),
                lambda: dk.decode_bwd_v4_ref(*ins, gp, gt, cd, t_layout=t_layout), 3)
            v4_ms[(t_layout, n)] = dict(fwd=f_ms, fwd_plain=fp_ms, bwd=b_ms, bwd_plain=bp_ms,
                                        fwd_bound=f_bound, bwd_bound=b_bound)
            log(f"[timing] v4 {layout} at N={n} {cd}: forward kernel {f_ms:.4f} ms "
                f"({2e-9 * n_vars * fwd_macs * n / f_ms:.2f} TFLOP/s), plain {fp_ms:.4f} ms, bound "
                f"{f_bound[0]:.4f} ms ({f_bound[1]}); backward kernel {b_ms:.4f} ms "
                f"({2e-9 * n_vars * bwd_macs * n / b_ms:.2f} TFLOP/s), plain {bp_ms:.4f} ms, bound "
                f"{b_bound[0]:.4f} ms ({b_bound[1]}); runs fwd {[round(t, 3) for t in f_times['kernel']]} "
                f"bwd {[round(t, 3) for t in b_times['kernel']]}")
    del frame, ins, ref_t, ref_n, g_p, g_t, gp, gt, ref

    # the v6 pair at the step's two launches: the v4s pair's operations and bytes
    v6_ms = {}
    for n in (20480, 4096):
        fw6, trig, cd_pe6, ref6, _, _ = v6_inputs(n, cd)
        g_p, g_t = point_major(*cotangents(n, seed=3))
        f_ms, fp_ms, f_times = alternating_ms(
            lambda: dk.fused_decode_jvp_v6(fw6, trig, cd_pe6, ref6, cd),
            lambda: dk.decode_jvp_v6_ref(fw6, trig, cd_pe6, ref6, cd), 5)
        b_ms, bp_ms, b_times = alternating_ms(
            lambda: dk.decode_bwd_kernel_v6(fw6, trig, cd_pe6, g_p, g_t, cd),
            lambda: dk.decode_bwd_v6_ref(fw6, trig, cd_pe6, g_p, g_t, cd), 5)
        matrices = [w.to(cd) if w.ndim >= 3 else w for w in fw6]
        f_bound = bound(2.0 * n_vars * fwd_macs * n, tensor_bytes(
            trig, cd_pe6, ref6, *matrices) + 4 * (n_vars * n + 3 * n_vars * n))
        b_bound = bound(2.0 * n_vars * bwd_macs * n, tensor_bytes(
            trig, cd_pe6, g_p, g_t, *matrices[:-1]) + 4 * sum(w.numel() for w in fw6[:-1]))
        v6_ms[n] = dict(fwd=f_ms, fwd_plain=fp_ms, bwd=b_ms, bwd_plain=bp_ms, fwd_bound=f_bound, bwd_bound=b_bound)
        log(f"[timing] v6 at N={n} {cd}: forward kernel {f_ms:.4f} ms ({2e-9 * n_vars * fwd_macs * n / f_ms:.2f} "
            f"TFLOP/s), plain {fp_ms:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]}); backward kernel "
            f"{b_ms:.4f} ms ({2e-9 * n_vars * bwd_macs * n / b_ms:.2f} TFLOP/s), plain {bp_ms:.4f} ms, bound "
            f"{b_bound[0]:.4f} ms ({b_bound[1]}); runs fwd {[round(t, 3) for t in f_times['kernel']]} "
            f"bwd {[round(t, 3) for t in b_times['kernel']]}")
    del fw6, trig, cd_pe6, ref6, g_p, g_t

    # the residual-sum kernels at the entry points' size: the forward's operations plus the
    # assembly (about 150 float operations per point), the point inputs once and 24 bytes out
    model.eval()
    ASSEMBLY_FLOPS = 150.0
    resid_ms = {}
    coords, nwp, cor = window_points(RESIDUAL_MAIN_N, seed=5)
    for version, (kernel_fn, plain_fn, _) in residual_fns.items():
        ins = residual_inputs(version, coords, nwp, cd)
        k_ms_, p_ms_, times_ = alternating_ms(
            lambda: kernel_fn(*ins, cor, scfg.obs_specs, compute_dtype=cd),
            lambda: plain_fn(*ins, cor, scfg.obs_specs, compute_dtype=cd), 3)
        flops = (2.0 * n_vars * fwd_macs + ASSEMBLY_FLOPS) * RESIDUAL_MAIN_N
        r_bound = bound(flops, tensor_bytes(*ins[1:], cor, *(w.to(cd) if w.ndim >= 3 else w for w in ins[0])) + 24)
        resid_ms[version] = dict(ms=k_ms_, plain=p_ms_, bound=r_bound)
        log(f"[timing] residual sums v{version} at N={RESIDUAL_MAIN_N} {cd}: kernel {k_ms_:.4f} ms "
            f"({flops / k_ms_ / 1e9:.2f} TFLOP/s), plain {p_ms_:.4f} ms, bound {r_bound[0]:.4f} ms ({r_bound[1]}); "
            f"runs kernel {[round(t, 3) for t in times_['kernel']]} plain {[round(t, 3) for t in times_['plain']]}")
    del ins, coords, nwp, cor

    # the in-kernel assembly against the split path through the entry points (weight fusion and
    # PE inputs included on both sides), by CUDA events and by host clock
    crossover = engine.FUSED_ASSEMBLY_MIN_N
    engine.FUSED_ASSEMBLY_MIN_N = 10**9  # fused_residual_losses(version=6): the split branch at any size
    try:
        for n in CROSSOVER_SIZES:
            coords, nwp, cor = window_points(n, seed=6)
            args = (model, tokens_w, coords, nwp, fh_w, cor, scfg.coord_spec, scfg.obs_specs, unit)
            for version in (4, 6):
                fused_fn = lambda: rk.kernel_residual_losses(*args, version=version)  # noqa: E731
                split_fn = lambda: engine.fused_residual_losses(*args, version=version)  # noqa: E731
                in_ms, split_ms, _ = alternating_ms(fused_fn, split_fn, 3)
                in_host = statistics.median(host_ms(fused_fn) for _ in range(3))
                split_host = statistics.median(host_ms(split_fn) for _ in range(3))
                log(f"[timing] residual losses v{version} at N={n:6d} {cd}: in-kernel assembly {in_ms:.3f} ms, split "
                    f"path {split_ms:.3f} ms by CUDA events; {in_host:.3f} and {split_host:.3f} ms by host clock "
                    f"(the engine's crossover is {crossover})")
    finally:
        engine.FUSED_ASSEMBLY_MIN_N = crossover
    del coords, nwp, cor, args
    model.train()
    torch.cuda.empty_cache()

    # the evaluation sweeps (host clock around a synchronize; the first run is a warm-up), and
    # one hour of the residual sweep split into its parts
    model.eval()
    sweeps = {"residual sweep": lambda: evaluate_residuals(model, scfg, [window]),
              "rmse sweep": lambda: evaluate_rmse_fullgrid(model, scfg, [window], per_lead=True),
              "field maps": lambda: residual_field_maps(model, scfg, [window], window=0, hour=7)}
    sweep_ms = {k: statistics.median([host_ms(fn) for _ in range(4)][1:]) for k, fn in sweeps.items()}
    log(f"[timing] evaluation of one window, {window.n_label_hours} hours x {GRID_POINTS} points (median of 3, "
        "host clock): " + ", ".join(f"{k} {v:.3f} ms" for k, v in sweep_ms.items()))

    def split_sweep_hour(t_hour: float):
        """One hour of the residual sweep, each part ended by a synchronize."""
        parts, box = {}, {}
        unit = {k: 1.0 for k in scfg.loss_factor}

        def set_up():
            box["grid"] = eval_common.LabelGrid.of(window, dev)
            box["tokens"], box["fh"], box["cube"] = eval_common.encode_window(model, window, dev)

        def conditioning():
            box["nwp"] = box["grid"].conditioning(window, box["cube"], t_hour)
            box["coords"] = box["grid"].coords(t_hour)

        def inputs():
            with torch.no_grad():
                weights, *box["points"] = engine._kernel_inputs(
                    model, box["tokens"], box["coords"], box["nwp"], box["fh"], scfg.coord_spec)
                box["fw"] = dk.fuse_decode_weights(weights)
                box["ref_t"] = box["nwp"].float().t().contiguous()

        def kernel():
            box["out"] = dk.fused_decode_jvp_v4t(box["fw"], *box["points"], box["ref_t"], cd)

        def assembly():
            with torch.no_grad():
                engine.packed_residual_losses_from_primal_tangents_t(
                    *box["out"], coriolis(box["grid"].lat), scfg.obs_specs, unit, with_clip=True)

        for name, fn in (("grid + encode (once per window)", set_up), ("interpolation + coordinates", conditioning),
                         ("PE inputs + weight fusion", inputs), ("forward kernel", kernel),
                         ("assembly + losses", assembly)):
            parts[name] = host_ms(fn)
        return parts

    runs = [split_sweep_hour(float(h)) for h in (0, 6, 12, 18)][1:]
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log("[timing] one hour of the residual sweep, split (median of 3, host clock, a synchronize after each "
        "part): " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    model.train()

    # one inference frame, split (host clock)
    model.eval()
    xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    split = {"host": [], "encode": [], "decode": [], "frame": []}
    for _ in range(4):
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
    log("[timing] one frame (median of 3, host clock): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f"; output {tuple(out.shape)}")
    model.train()

    # one training step of each kind (host clock around a synchronize), then split into parts
    def whole_step(cfg_, with_pde):
        times_ = [host_ms(lambda: step_fns[cfg_](state, batch, with_pde)) for _ in range(5)]
        return statistics.median(times_[1:])

    step_fns = {name: ts.make_train_step(ts.step_config_from_cfg(cfg, pde_engine=name))
                for name in ("kernel", "jvp", "linearize")}
    step_fns["kernel v4"] = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=4))
    step_fns["kernel v4 [N, 6]"] = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=4, var_major=False))
    step_fns["kernel v6"] = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=6))
    whole = {"pde kernel": whole_step("kernel", True), "pde kernel v4": whole_step("kernel v4", True),
             "pde kernel v4 [N, 6]": whole_step("kernel v4 [N, 6]", True),
             "pde kernel v6": whole_step("kernel v6", True),
             "pde jvp": whole_step("jvp", True), "pde linearize": whole_step("linearize", True),
             "data-only": whole_step("kernel", False)}
    log("[timing] one training step (median of 4, host clock): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in whole.items()))

    def split_step(engine_name: str, with_pde: bool, version: int = 7):
        """The step's parts, each ended by a synchronize; mirrors train_step for one window."""
        scfg_ = ts.step_config_from_cfg(cfg, pde_engine=engine_name, kernel_version=version)
        pred_loss = ts.build_loss(scfg_.prediction_loss, beta=scfg_.prediction_beta)
        factors = scfg_.factors()
        parts, box = {}, {}
        state.optimizer.zero_grad(set_to_none=True)

        def encode():
            fh = (batch.forecast_h / scfg_.forecast_time_period)[:, None]
            box["fh"], box["tokens"] = fh[0], model.encode(batch.field, fh)[0]

        def decode():
            if with_pde:
                for key, pts in (("margin", batch.margin), ("inter", batch.inter)):
                    coords = torch.stack([pts.x[0], pts.y[0], pts.t[0]], dim=-1)
                    if version == 6:  # [N, 6] only
                        box[key] = engine.fused_kernel_fields(
                            model, box["tokens"], coords, pts.nwp[0], box["fh"], scfg_.coord_spec,
                            scfg_.obs_specs, trainable=True, version=6, raw_tangents=True)
                    else:
                        box[key] = engine.fused_kernel_fields_t(
                            model, box["tokens"], coords, pts.nwp[0], box["fh"], scfg_.coord_spec,
                            engine=engine_name, version=version)
            else:
                m = batch.margin
                pe_ = ts.encode_coord(m.x[0], m.y[0], m.t[0], scfg_.coord_spec)
                box["pred"] = model.decode(box["tokens"], pe_, m.nwp[0], box["fh"])

        def losses():
            if with_pde:
                labels = batch.margin.labels[0]
                assemble = engine.packed_residual_losses_from_primal_tangents
                if version != 6:
                    labels, assemble = labels.t(), engine.packed_residual_losses_from_primal_tangents_t
                total = pred_loss(box["margin"][0], labels) * factors["margin_factor"]
                for key, pts in (("margin", batch.margin), ("inter", batch.inter)):
                    total = total + assemble(*box[key], pts.f[0], scfg_.obs_specs, factors, with_clip=True,
                                             constants=scfg_.constants)["total"]
            else:
                total = pred_loss(box["pred"], batch.margin.labels[0]) * factors["margin_factor"]
            box["total"] = total

        parts["encode"] = host_ms(encode)
        parts["decode forward"] = host_ms(decode)
        parts["assembly + loss"] = host_ms(losses)
        parts["backward"] = host_ms(lambda: box["total"].backward())
        parts["clip + optimizer"] = host_ms(lambda: ts.apply_gradient_update(scfg_, state, {}))
        return parts

    for label, engine_name, with_pde, version in (
            ("pde kernel", "kernel", True, 7), ("pde kernel v4", "kernel", True, 4),
            ("pde kernel v6", "kernel", True, 6), ("pde jvp", "jvp", True, 7), ("data-only", "kernel", False, 7)):
        runs = [split_step(engine_name, with_pde, version) for _ in range(4)][1:]
        parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        log(f"[timing] {label} step split (median of 3, host clock, a synchronize after each part): " +
            ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()) + f"; sum {sum(parts.values()):.3f} ms")
    log(f"[timing] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 14. profile (only with --profile): the device's busy share and its largest kernels ----
    if "--profile" in sys.argv[1:]:
        from torch.profiler import ProfilerActivity, profile

        def one_frame():
            model.eval()
            runner.predict_grid(model, dcfg, window, field, window.forecast_h, 6.5)
            model.train()

        def one_sweep():
            model.eval()
            evaluate_residuals(model, scfg, [window])
            model.train()

        from torch.autograd import DeviceType

        for label, fn, plain_wall in (
                ("pde kernel step", lambda: step_fns["kernel"](state, batch, True), whole["pde kernel"]),
                ("pde kernel v4 step", lambda: step_fns["kernel v4"](state, batch, True), whole["pde kernel v4"]),
                ("pde kernel v6 step", lambda: step_fns["kernel v6"](state, batch, True), whole["pde kernel v6"]),
                ("pde jvp step", lambda: step_fns["jvp"](state, batch, True), whole["pde jvp"]),
                ("data-only step", lambda: step_fns["kernel"](state, batch, False), whole["data-only"]),
                ("frame", one_frame, split["frame"]),
                ("residual sweep", one_sweep, sweep_ms["residual sweep"])):
            fn()
            torch.cuda.synchronize()
            reps = 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = host_ms(lambda: [fn() for _ in range(reps)]) / reps
            # device-side events only: a host-side operator also carries its kernels' time,
            # and an annotation mirrored onto the device's timeline spans kernels counted already
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
            busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
            if not busy > 0:
                raise AssertionError(f"the profiler saw no device time in the {label}")
            top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
            log(f"[profile] {label}: device busy {busy:.3f} ms in {sum(e.count for e in events) / reps:.0f} "
                f"kernels and copies; {plain_wall:.3f} ms unprofiled (idle {100 * (1 - busy / plain_wall):.1f}%), "
                f"{wall:.3f} ms under the profiler; largest: " + "; ".join(
                    f"{e.key[:60]} {e.self_device_time_total / 1e3 / reps:.3f} ms x{e.count / reps:.0f}"
                    for e in top))

    # max_abs_err is over all outputs together; max_rel_err is the number held to the
    # tolerance: of 1 + max|plain| (primal), of each tangent's or weight's own largest value.
    # launches: the counts of the main paths, each read just after its path ran from counts
    # of 0 (inference, the kernel_version=7 steps, the evaluation sweeps, the kernel_version=4
    # steps, the residual entry points, the kernel_version=6 steps); errors and times at the
    # size of the path's larger launch.
    main_n = 20480  # the larger of the two launches of a PDE step
    t = v4s_ms[main_n]
    csrc = "deepphysinet_tpu_torch/csrc/"
    jax_file = "deepphysinet_tpu/ops/decode_kernel.py"

    def v4_entry(name, source, replaces, t_layout, n, which, errs_, rels_):
        tm = v4_ms[(t_layout, n)]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": f"{jax_file}:{replaces}",
                "launches": eval_launches[name] + train4_launches[name],
                "launches_eval": eval_launches[name], "launches_train": train4_launches[name],
                "max_abs_err": errs_[(t_layout, cd, n)], "max_rel_err": rels_[(t_layout, cd, n)], "points": n,
                "ms": tm[which], "plain_ms": tm[which + "_plain"], "bound_ms": tm[which + "_bound"][0],
                "bound_by": tm[which + "_bound"][1], "library_ms": None}

    def v6_entry(name, source, replaces, which, errs_, rels_):
        tm = v6_ms[main_n]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": f"{jax_file}:{replaces}",
                "launches": train6_launches[name] + resid_launches[name],
                "launches_train": train6_launches[name], "launches_eval": resid_launches[name],
                "max_abs_err": errs_[(cd, main_n)], "max_rel_err": rels_[(cd, main_n)], "points": main_n,
                "ms": tm[which], "plain_ms": tm[which + "_plain"], "bound_ms": tm[which + "_bound"][0],
                "bound_by": tm[which + "_bound"][1], "library_ms": None}

    def residual_entry(name, version, replaces):
        tm = resid_ms[version]
        return {"name": name, "route": "cuda", "source": csrc + "residual_sums.cu",
                "replaces": f"deepphysinet_tpu/ops/residual_kernel.py:{replaces}",
                "launches": resid_launches[name], "max_abs_err": resid_err[(version, cd, RESIDUAL_MAIN_N)],
                "max_rel_err": resid_rel[(version, cd, RESIDUAL_MAIN_N)], "points": RESIDUAL_MAIN_N,
                "ms": tm["ms"], "plain_ms": tm["plain"], "bound_ms": tm["bound"][0], "bound_by": tm["bound"][1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        {"name": "decode_primal_v4t", "route": "cuda", "source": csrc + "decode_primal.cu",
         "replaces": f"{jax_file}:956",
         "launches": primal_launches, "launches_eval": eval_launches["decode_primal_v4t"],
         "max_abs_err": errs[(cd, GRID_POINTS)], "max_rel_err": rel_errs[(cd, GRID_POINTS)],
         "points": GRID_POINTS,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": primal_bound[0], "bound_by": primal_bound[1],
         "library_ms": None},
        {"name": "fused_decode_jvp_v4s", "route": "cuda", "source": csrc + "decode_jvp_v4s.cu",
         "replaces": f"{jax_file}:2358",
         "launches": fwd_launches, "max_abs_err": fwd_err[(cd, main_n)],
         "max_rel_err": fwd_rel[(cd, main_n)], "points": main_n,
         "ms": t["fwd"], "plain_ms": t["fwd_plain"], "bound_ms": t["fwd_bound"][0],
         "bound_by": t["fwd_bound"][1], "library_ms": None},
        {"name": "decode_bwd_kernel_v4s", "route": "cuda", "source": csrc + "decode_bwd_v4s.cu",
         "replaces": f"{jax_file}:2508",
         "launches": bwd_launches, "max_abs_err": bwd_err[(cd, main_n)],
         "max_rel_err": bwd_rel[(cd, main_n)], "points": main_n,
         "ms": t["bwd"], "plain_ms": t["bwd_plain"], "bound_ms": t["bwd_bound"][0],
         "bound_by": t["bwd_bound"][1], "library_ms": None},
        # the [N, 6] and [6, N] forms share one source; the sweeps decode one frame per launch
        v4_entry("fused_decode_jvp_v4", "decode_jvp_v4.cu", 781, False, GRID_POINTS, "fwd", v4_fwd_err, v4_fwd_rel),
        v4_entry("fused_decode_jvp_v4t", "decode_jvp_v4.cu", 855, True, GRID_POINTS, "fwd", v4_fwd_err, v4_fwd_rel),
        v4_entry("decode_bwd_kernel_v4", "decode_bwd_v4.cu", 1562, False, main_n, "bwd", v4_bwd_err, v4_bwd_rel),
        v4_entry("decode_bwd_kernel_v4t", "decode_bwd_v4.cu", 1642, True, main_n, "bwd", v4_bwd_err, v4_bwd_rel),
        # the v6 pair shares its sources with the v4s pair (another operand layout)
        v6_entry("fused_decode_jvp_v6", "decode_jvp_v4s.cu", 1978, "fwd", v6_fwd_err, v6_fwd_rel),
        v6_entry("decode_bwd_kernel_v6", "decode_bwd_v4s.cu", 2115, "bwd", v6_bwd_err, v6_bwd_rel),
        residual_entry("fused_residual_sums_v6", 6, 127),
        residual_entry("fused_residual_sums_v4", 4, 48),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
