"""On-card check of the PyTorch port: builds its CUDA kernels, drives inference, training
and the evaluation sweeps.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. build    -- compile the nine sources under ``deepphysinet_tpu_torch/csrc/`` with
               nvcc, all at once (and four timing variants of the encoder's), and log
               registers, spills and shared memory; build the host data layer's C++
               kernels (``native/src/dpn_native.cc``) with g++;
2. primal   -- the primal decode kernel against its plain PyTorch version on the
               card, at 37,265 (one 145 x 257 frame), 1,000 and 3 points and at the
               point-block edges 17, 64, 65 and 129, bf16 and f32;
3. infer    -- the flagship model (configs/DeepPhysiNet_NCEP_cfg.py, random weights
               from a seeded generator) on a seeded synthetic window:
               ``predict_grid`` at three time offsets and ``predict_points`` at 3, 300
               and 50,000 points, with the launch count of the kernel, output
               checks, and one frame against the plain decode;
4. forward  -- the v4s forward kernel (primal + three tangents) against its plain
               version at 20,480, 4,096, 1,000 and 3 points of one flagship window and
               at the 64-point block edges 17, 64, 65 and 129 (the backward's point tile
               too), bf16 and f32, the points near a relu's kink left out and counted;
5. backward -- the v4s backward kernel against its plain version at the same sizes
               with seeded random cotangents, per weight, and two runs of it; a reading
               of the plain version's rounding on the v4s operands (as in phase 7); and
               the ``torch.autograd.Function`` that joins the two kernels against
               autograd of the plain forward (weights, ``ref_t``, the zero cotangents);
6. train    -- the flagship training step under the ``'kernel'`` engine on a seeded
               synthetic batch (20,480 margin + 4,096 collocation points): 3
               data-only steps, then 3 steps with the PDE terms, with the launch
               counts of both kernels; then, from one starting state, the
               gradients of one PDE step under ``'kernel'`` against ``'jvp'`` (the
               plain version under autograd), for ``kernel_version`` 7, 4, 6 and 2;
7. v4       -- the v4 forward and backward kernels against their plain versions in
               both layouts ([N, 6] and [6, N]), bf16 and f32, at 37,265, 20,480, 4,096,
               1,000 and 3 points of one flagship frame and at 17, 64, 65 and 129; the
               two layouts against each
               other; two runs of the backward; and ``FusedDecodeJvpV4`` in both
               layouts against autograd of the plain forward; a reading of the plain
               version's rounding (cuBLAS's z against one FMA a term in k order, and
               what float64 sums change in T(p) and the tangents), which the bf16
               kernel's recomputation near a rounding tie rests on;
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
               bf16 and f32, at the sizes of phase 4; the forward
               against the v4s kernel on the same points and weights (the same
               bits); two runs of the backward; ``FusedDecodeJvpV6`` against
               autograd of the plain forward;
11. residual -- the two residual-sum kernels (decode and PDE assembly in one launch)
               against their plain versions, bf16 and f32, ``with_clip`` on and off,
               at 49,152, 65,536 and 50,001 points of the window and at the point-block
               edges 1, 17, 64, 65 and 129, each beside a
               float64 sum of the plain version's per-point terms, each equation also
               allowed the decode's own disagreement carried through its terms (the
               forward kernel's decode against the plain decode, float64 derivatives),
               with the points that carry it; two runs (the same bits); the kernel's
               term of single points against the forward kernel's decode's; against the
               split path on the same points; then the
               entry points: ``fused_residual_losses`` with versions 6 and 2 at 40,960
               (split branch) and 65,536 points (in-kernel) and
               ``kernel_residual_losses(version=4)`` at 65,536, with the launch counts;
12. train v6 -- from the seeded state: one PDE step under ``kernel_version=6``
               ('kernel' against 'jvp', and against ``kernel_version=7``); then 3 PDE
               steps with ``kernel_version=6``, with the launch counts;
13. v2      -- the v2 and v3 forward kernels (the uncollapsed decode; v3 with the PE
               computed in the kernel) against their plain versions, bf16 and f32, at
               20,480 (v2; v3 at 37,265 and at 20,480 of the same frame), 1,000, 3 and 1
               (v3) points and at the block edges 17, 64, 65 and 129, v3 twice (the same
               bits), each kernel's rows at a smaller size the same bits as the first n
               of its largest call; a reading of the plain version's rounding on the v2
               operands and on v3's channel-major operands of one frame (float64 sums in
               place of cuBLAS's at each of its six bf16 rounding points), which the bf16
               kernels' recomputation near a tie rests on; ``FusedDecodeJvpV2`` (kernel
               forward, plain backward) against autograd of the plain forward;
14. train v2 -- 3 PDE steps with ``kernel_version=2`` (the seeded-state comparisons ran
               in phase 6), with the launch counts;
15. v4pe, v5 -- the v4pe and v5 forward kernels against their plain versions, bf16 and
               f32, at 37,265, 1,000, 3 and 1 points and at the block edges, v4pe twice (the
               same bits), the rows at a smaller size as in phase 13; the bf16 rows of the
               PE front ends, bit for bit: the tensor-core bodies' (one sincosf an angle)
               against the CUDA-core bodies' (sinf, cosf), and their recompute's against
               their front end's; ``fused_kernel_fields(in_kernel_pe=True)`` on one frame
               (the v4pe kernel) against the same call without it (the v4 kernel on the
               prepared PE); direct calls of v3 and v5 on one frame;
16. attention -- the single-tile and flash attention kernels against their plain
               versions, bf16 and f32, at B = 1, 8 heads of 32 and 3 to 4,096 tokens,
               and 8 heads of 16 and of 64 at 287 and 1,025 tokens, each with its
               launch shape; ``FusedAttention`` with either kernel's forward against
               autograd of the plain forward, with the launch counts;
17. encoder -- the fused encoder kernel against its plain version at flagship width,
               bf16 (the tensor-core body) and f32 (the CUDA-core body), at 287 tokens and
               at 1, 15, 16, 17 and 33 (the bf16 body's 16-row groups and 32-query
               attention units); ``encode_fused`` (two batch items, two launches) against
               ``PhysicsNet.encode``;
18. paths   -- ``predict_grid`` with ``attn_impl='pallas'`` and ``'flash'`` against the
               default model on the same weights; one PDE step's loss and gradients
               under ``'pallas'`` against the default; 3 PDE steps under ``'pallas'``,
               with the launch counts;
19. disk    -- inference from disk at flagship width: a synthetic GeoTIFF tree (labels
               145 x 257, inputs 37 x 65, two init times) written with the port's
               generator, the seeded flagship model saved with the port's
               ``save_checkpoint``, and ``python -m deepphysinet_tpu_torch.cli --mode
               inference`` (called in process, ``--set`` overrides) on six hours, with
               the primal kernel's launch count (one a 40,960-point chunk and hour); every
               exported T GeoTIFF read back against its grid flipped north-up, with the
               study area's geo-transform; one hour against the plain decode; the native
               host library (built in phase 1) against numpy on that hour's grid; one
               hour by host clock, split into dataset open, raster reads (token
               matrix and NWP cube), conditioning, encode, decode and export;
20. trainer -- training from disk at flagship width: ``python -m deepphysinet_tpu_torch.cli
               --mode train`` (in process) on phase 19's tree from its seeded checkpoint,
               the flagship's batch, workers and engine, 10 steps (4 data-only, then the
               PDE terms, a validation batch at each log step), with the v4s kernels'
               launch counts, the logged losses finite and the checkpoint's metadata; a
               resumed run of 2 more steps from the physics_latest it wrote (its first
               step at the saved step, the scheduled rate of its epoch, the saved
               parameters bit for bit, Adam's step count); ``--mode test`` on the final
               checkpoint (the full-grid RMSE, one primal launch a window's hour); one
               step by host clock, split into waiting on the loader, the copy to the
               device, the step, the metric fetch, validation and the epoch save, and
               whether the loader keeps up with the step;
21. device trainer -- training with the points sampled on the device
               (``--set train_cfg.tpu.sample_mode=device``) through the command line on phase 19's
               tree and checkpoint, the data in memory: 12 steps of the iid sampler (six epochs of
               the two windows), 6 of the pool sampler and 2 resumed from the first run's
               physics_latest, with the v4s kernels' launch counts, the logged losses finite, each
               run's cube cache (two builds, then hits), two validations with the same parameters
               identical, the resumed run's first step; on one sampled batch on the card the labels
               and the pool's conditioning bit for bit, the conditioning against the host dataset's
               float64 interpolation, the draws by chi-squared; the step split by host clock beside
               phase 20's and the sampler alone by CUDA events; then the first run again with no
               save until its last step, beside it;
22. tools   -- the port's command-line tools (``deepphysinet_tpu_torch/tools/``) in process on
               phase 19's tree and phase 20's checkpoint: ``evaluate --off_lattice`` (its primal
               launches, one a slot and set; the generator's defaults against the evaluator's;
               the closed-form truth against the tree's labels; one window's off-lattice decode
               against the plain decode), ``--full_grid --per_lead``, ``--residuals`` and the
               subsampled mode (25 primal or v4t launches a window, none), ``--save_maps``
               naming matplotlib where it is missing; ``infer_stations`` (its rows, each bit for
               bit against ``predict_points``); ``derive_products --vs_model`` (its GeoTIFFs read
               back, finite statistics, one primal launch); each tool's host-clock seconds;
22b. etl    -- the ETL tools (``deepphysinet_tpu_torch/tools/``) from raw archives to a tree, and the
               main path on it: phase 19's tree written as users download it (one GRIB2 file an
               init time, leads 0 to 24 h: sp, 2t, 2d, 10u, 10v and u, v, t, gh, q at five levels;
               ERA5 single-level NetCDF-3 files, packed int16), then ``run_etl`` (each tool's
               ``main(argv)`` in process, the README's order) into a fresh tree with phase 19's
               constants and coordinate pickles, the label extraction again with two workers (the
               same files byte for byte); every raster held to phase 19's at
               its codec's error (half a GRIB packing quantum from each message's own E and D, half
               an int16 quantum, q2 and rio through their formulas from those allowances), the index
               keys equal; ``--mode train`` on it from phase 19's seeded checkpoint (host-sampled, the
               PDE terms on) with the v4s launch counts phase 20 expects for the same steps;
               ``--mode inference`` on two hours (primal launches) and ``--mode test`` on the
               checkpoint it saved; one loader item of the same window from each tree by host clock
               (alternating, 3 each) with the tiles each item decodes;
23. options -- the encoder's model options at flagship width, bf16 (``--set meta_cfg.attn_type=prob
               --set meta_cfg.fused_qkv=True``): one encode of the seeded model, each layer's
               ProbSparse rows against full attention with the same roundings, the other rows the
               value mean, the key sample the numpy copy of JAX's draw, the selected queries against
               a float32 run, fused q/k/v against the three projections (float32); ``--mode train``
               on phase 19's tree (host-sampled, on the device, resumed) with the v4s launch counts,
               ``--mode inference`` on two hours and ``--mode test`` (primal launches); fused q/k/v
               under ``attn_impl='pallas'`` (one encode and one PDE step, the single-tile kernel
               against its plain version); readings of encodes, ProbSparse attention at 4,096 tokens
               beside the flash kernel and PDE steps; ResNet-50 on the card against the CPU;
24. dist    -- data-parallel training at flagship width on phase 19's tree (ROADMAP A7): (a)
               ``python -m torch.distributed.run --nproc_per_node 1`` runs ``cli --dist`` (NCCL,
               world size 1) host- and device-sampled with a PDE step, the child's v4s launches
               against the expected count and the host-sampled lead times snapped to the window;
               (b) two ranks on the one card over gloo, one PDE step each on its window, float32
               (TF32 off) and bf16, against one process's step over both windows from the same
               state, with the v4s launches of each rank and the gloo all-reduce's time; (c) the
               ranks resume a one-process checkpoint and rank 0's checkpoint resumes in one process;
24b. parity -- the kernel paths at flagship width against the JAX package
               (``deepphysinet_tpu_torch/diagnostics/flagship_parity.py``): the seeded weights' and
               inputs' checksums against ``flagship_record.npz`` (which the JAX package writes on the
               CPU), then float32 (TF32 off) and bf16 readings of the port on the card, each held to
               the record's at the larger of a floor and four times JAX's own spread: the encoded
               tokens, ``predict_grid``'s frame (the primal kernel), the v4s forward's fields at 4,096
               points, ``fused_residual_losses(version=7)`` at 40,960 points, one PDE step's losses,
               gradient norms, gradient and update probes (the v4s pair), and in float32 the B = 2
               step and its two micro-batches, with the three kernels' launch counts;
25. timing  -- by CUDA events, medians, alternating order: each kernel and its
               plain version at the main paths' sizes (the attention kernels beside one
               ``scaled_dot_product_attention`` call and a bound of three terms, the
               single-tile kernel also at 1,024 tokens; the primal, v4 pair, v4s pair,
               v2, v3 and v4pe forward with their points a block, ptxas registers and spills,
               and their products as batched ``torch.bmm`` calls; the v4 backward also at
               4,096 points; the v4 and v4s / v6 backward's bytes of atomic adds a
               launch; the residual sums with their points a block, ptxas registers and
               spills, scratch bytes and products as batched ``torch.bmm`` calls), and the
               in-kernel residual assembly against the split path at 40,960 to 131,072
               points; the fused encoder kernel on the device alone and, in bf16, by stage
               (builds without one stage's units, DPN_ENCODER_SKIP); v5's ptxas and its
               products (the v4 forward's) as batched ``torch.bmm`` calls; one frame
               through ``fused_kernel_fields`` with and without
               ``in_kernel_pe`` (CUDA events and host clock); by host
               clock around a synchronize: one frame, one training step of each
               kind, one residual sweep, split into their parts, and one encode
               through ``PhysicsNet.encode`` and ``encode_fused``;
26. profile -- only with ``--profile``: ``torch.profiler`` over three steps of each
               kind, three frames and three residual sweeps, for the device's busy share.

The last three lines of standard output are a JSON object with each kernel's
numbers, the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
import ctypes
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
# the point-block edges of the tensor-core decode kernels (64 points a block for v4, v4s, v6 and
# v2, forward and backward, 128 for the primal): a ragged block alone, one block, one past it, one
# past two 64-point blocks
BLOCK_EDGE_SIZES = (17, 64, 65, 129)
V4S_SIZES = (20480, 4096, 1000, 3) + BLOCK_EDGE_SIZES  # the step's two launches, ragged edges
PRIMAL_SIZES = (GRID_POINTS, 1000, 3) + BLOCK_EDGE_SIZES  # one frame, ragged edges
V4_SIZES = (GRID_POINTS, 20480, 4096, 1000, 3) + BLOCK_EDGE_SIZES  # a frame, the step's launches, edges
TIMING_POINTS = 20480 + 4096  # the points one PDE step decodes
# the residual-sum kernels: at and above the engine's crossover, one ragged size, the point-block
# edges (64 points a block in bf16, 32 in f32); the split branch's size; the sizes of the in-kernel
# against split timing
RESIDUAL_SIZES = (49152, 65536, 50001, 1) + BLOCK_EDGE_SIZES
RESIDUAL_MAIN_N, RESIDUAL_SPLIT_N = 65536, 40960
V2_SIZES = (20480, 1000, 3) + BLOCK_EDGE_SIZES  # the step's larger launch, ragged edges
PE_SIZES = (GRID_POINTS, 1000, 3, 1) + BLOCK_EDGE_SIZES  # one frame, ragged edges
V3_SIZES = (GRID_POINTS, 20480) + PE_SIZES[1:]  # one frame, v2's larger launch of it, ragged edges
CROSSOVER_SIZES = (40960, 49152, 65536, 131072)

# The card's published peaks (NVIDIA H100 SXM data sheet): dense bf16 tensor-core
# rate and HBM3 bandwidth.  A kernel's bound is the larger of its operations
# over the first and its bytes (inputs read once, outputs written once) over
# the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# The special-function unit evaluates 16 exponentials a clock on each SM (NVIDIA's CUDA
# programming guide, throughput of arithmetic instructions, compute capability 9.0); at the
# SM clock that nvidia-smi reports as clocks.max.sm this is the attention kernels' third bound.
SFU_EXP_PER_CLOCK_PER_SM = 16

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
# lie that close, so at the 3-point size one of them does in a tenth of the runs).  The v4s,
# v6 and v2 checks run on the training batch's points, of which 7 to 8% lie that close; at their
# block-edge sizes (17 to 129 of the same first points) the count is printed and not held to
# the share, which a handful of points cannot estimate (4 of the first 17 in bf16).  The v4s and v6
# forward checks hold the share at KINK_SHARE_SIZES only (two of three points happened in a few
# percent of runs, ROADMAP C36); their smaller calls run on the first n points of the largest call's
# inputs and must give that call's first n rows bit for bit, so that every point is held, kink
# points included (as ``point_major_check`` holds the v2 / v3 / v4pe / v5 checks).
KINK_EPS = 2e-6
KINK_SHARE = 0.2
KINK_SHARE_SIZES = (20480, 4096, 1000)
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
# difference may flip the bf16 rounding of p or of a tangent (as RTOL_BWD).  A point's term
# can be an ill-conditioned function of the decode's outputs (without the clip a density of
# 1e-4, where p_x / rho turns one ulp of the normalized output into 7e-5 of rho; a gas law at
# 50 K that subtracts two pressures of 36,000 Pa), so each equation is also allowed what the
# decode's own disagreement moves its terms by, to first order: the sum over the points of
# |d term / d output| x |kernel decode - plain decode| over the 24 outputs, in float64
# (``decode_allowance``; the kernel decode is the forward kernel's, whose bits the
# residual kernel's decode has: the check samples that, a point's term alone against the
# term of the forward kernel's decode; the derivatives are the larger of those at the two
# decodes, which bounds the change of a square or a quotient).  The vapor
# equation switches a whole term on delta = 1[Dp/Dt < 0 and q >= q_s], and with the clip
# its Dp/Dt or Dq/Dt drops to zero where p or q crosses a bound: a point within SWITCH_EPS
# of a switch of delta (Dp/Dt = 0, q = q_s, the pole of q_s's Tetens formula), or within
# KINK_EPS of a bound of p or q, may land on the other side in the kernel, only sums come
# out, so that equation alone is also allowed the size of those points' terms (printed
# with their count).  The same bounds hold the in-kernel path to the split path through
# the entry points, whose decodes sum in different orders (the split path's bf16 forward
# runs on the tensor cores), so that a p on its lower bound in one may lie just above it
# in the other.
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
# kernel_version=2 has no backward kernel (as on the TPU): 'kernel' is FusedDecodeJvpV2, the v2
# forward kernel and the gradient of the v2 XLA twin, which reads wo in float32 where the kernel
# rounds it (C19).  The step's own 'jvp' under version 2 is the collapsed v4 plain version,
# another function in bf16, so the engine comparison of kernel_version=2 runs 'jvp' as the kernel
# engine's route with the v2 plain version in place of the kernel, differentiated as
# FusedDecodeJvpV2 is: the kernel's rounding in the values, the twin's in the gradient.  The
# version comparison holds it to kernel_version=7 by the same rule as 4 against 7.  What C19
# alone moves (the gradient of the kernel's rounding against the twin's) is printed, not held:
# it is JAX's design.
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


# The attention kernels (ops/attention.py) at B = 1, H = 8, E = 32 (the flagship's heads): the
# single-tile kernel up to its routing limit, the flash kernel across key blocks of 256.
ATTN_TILE_SIZES = (3, 287, 1024)
ATTN_FLASH_SIZES = (3, 287, 1025, 2048, 4096)
ATTN_HEADS, ATTN_HEAD_DIM = 8, 32
# the other head widths the kernels take (one and four k16 steps of their products), both
# kernels at the encoder's length and past the single-tile kernel's routing limit
ATTN_OTHER_HEAD_DIMS = (16, 64)
ATTN_OTHER_SIZES = (287, 1025)
# the sizes at which the attention kernels are timed: both at the encoder's length, the
# single-tile kernel at its routing limit, the flash kernel at a long sequence
ATTN_TIMED = (("attention_tile", 287), ("attention_flash", 287), ("attention_tile", 1024),
              ("attention_flash", 4096))
# Each kernel against its plain version, max |kernel - plain| over the output.  float32:
# TOL_ATTN_F32 * (1 + max|plain|): the same arithmetic, float32 sums in another order (and
# the single-tile kernel's sum of exp rescaled as its running max grows).  bf16: one bf16 step
# of max|plain|, since both sides round p and the output at the same places and a summation
# difference can flip one rounding.
TOL_ATTN_F32 = 1e-5
# FusedAttention (kernel forward, plain backward) against autograd of the plain forward, per
# gradient relative to its largest entry, float32: the same gradient in another summation
# order.  In bf16 the two round at other places (C14), so that reading is printed, not held.
RTOL_ATTN_GRAD = 1e-5
# The fused encoder kernel against its plain version (and encode_fused against
# PhysicsNet.encode), relative to the largest token.  float32: TOL_ENC_F32, float32 sums in
# another order through four layers.  bf16: a summation difference flips a bf16 rounding
# somewhere, and four layers of products, attention and LayerNorms carry it into every token
# (20% of them end more than a step of their own size apart), so the tokens are held by the
# largest: max error within TOL_ENC_BF16_STEPS bf16 steps of the largest token, mean error
# within TOL_ENC_BF16_MEAN of such a step (measured on an H100: one step, mean 0.05-0.07).
TOL_ENC_F32 = 1e-4
TOL_ENC_BF16_STEPS = 4
TOL_ENC_BF16_MEAN = 0.25
# predict_grid with attn_impl='pallas' or 'flash' against the default model (plain attention at
# 287 tokens) on the same weights: the single-tile kernel is the plain path's function and the
# flash kernel rounds its probabilities elsewhere in bf16 (C15), and the encoder carries either
# difference through four layers: tokens held as the encoder kernel's (TOL_ENC_*).  The
# hypernet makes the decode's weights from the tokens, so the fields move more: in normalized
# units within TOL_PATH_FIELDS * (1 + the largest field) (measured: 0.46% and 0.67%).
TOL_PATH_FIELDS = 2e-2


def bf16_step(x: torch.Tensor) -> float:
    """The spacing of bfloat16 numbers at the largest |x|."""
    return float(2.0 ** (np.floor(np.log2(float(x.abs().max()))) - 7))


def amax(x: torch.Tensor) -> float:
    """max |x|, 0 for no element (every point left out near a kink)."""
    return float(x.abs().max()) if x.numel() else 0.0


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


def device_ms(fn, iters: int) -> float:
    """Median ms per call of five runs of ``iters`` calls queued behind a sleeping kernel, so that
    the events time the device alone and not the host's launch overhead (a call whose device work
    is shorter than its host work reads its host time under ``cuda_ms``)."""
    fn()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(iters * 2e5))  # about 100 us a call at 2 GHz, more than a call's host time
        runs.append(cuda_ms(fn, iters))
    return statistics.median(runs)


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


def vapor_switch_set(engine, scfg, primal, tang, with_clip: bool, eps: float, bound_eps: float):
    """Of a decode's points (``primal`` [N, 6], ``tang`` [3, N, 6]): those within eps of a
    switch of the vapor equation's term ([N] bool), and the most each squared term can move
    ([N]).  The term switches on delta = 1[Dp/Dt < 0 and q >= q_s] where Dp/Dt = 0 and where
    q = q_s, and q_s jumps through the pole of the Tetens formula (p = 0.378 e_s); with the
    clip, Dp/Dt and Dq/Dt jump where p or q crosses a bound, which zeroes its derivative on
    one side: the points whose normalized p or q lies within bound_eps * (1 + its largest)
    of a bound are allowed their terms with the derivatives of either side.  A bound is a
    kink of the fields that the primal decides, as a relu's argument decides its kink, so
    the checks pass KINK_EPS."""
    c = scfg.constants
    P, D = engine.packed_physical_from_primal_tangents(primal, tang, scfg.obs_specs, with_clip)
    u, v, p, T, q = P[0], P[1], P[2], P[3], P[4]
    q_s = torch.clamp(engine.saturation_specific_humidity_packed(p, T), min=1e-6)
    e_s = 6.112 * torch.exp(17.67 * (T - 273.15) / (T - 273.15 + 243.5)) * 100.0
    f_fac = (c.latent_heat * (1.0 + 0.608 * q) * c.r_d - c.c_p * c.r_v * T) / (
        c.c_p * c.r_v + T * T + c.latent_heat**2 * q_s) * q_s * T

    def derivatives_and_size(D_):
        dp = D_[2, 2] + u * D_[0, 2] + v * D_[1, 2]
        dq = D_[2, 4] + u * D_[0, 4] + v * D_[1, 4]
        on = -dp * f_fac / (p + c.eps_rho) + dq
        return dp, torch.maximum(on * on, dq * dq)

    dp, size = derivatives_and_size(D)
    # an exact tie is no switch (Dp/Dt = 0 of a clipped p, q = q_s of a q clipped to the floor
    # of q_s): the clip's own switch is its bounds, below
    near = ((dp != 0) & (dp.abs() < eps * dp.abs().max())) | ((q != q_s) & ((q - q_s).abs() < eps * q_s)) | (
        (p - 0.378 * e_s).abs() < eps * p)
    if with_clip:
        on_bound = torch.zeros_like(near)
        for i in (2, 4):
            spec = scfg.obs_specs[i]
            scale = 1.0 + float(primal[:, i].abs().max())
            for b in spec.bound:
                on_bound |= (primal[:, i] - (b - spec.norm_factor[0]) / spec.norm_factor[1]).abs() < bound_eps * scale
        _, free = derivatives_and_size(engine.packed_physical_from_primal_tangents(
            primal, tang, scfg.obs_specs, False)[1])
        size = torch.where(on_bound, torch.maximum(size, free), size)
        near |= on_bound
    return near, size


def vapor_switch_points(engine, scfg, primal, tang, with_clip: bool, eps: float, bound_eps: float):
    """How many points lie near a switch of the vapor term, and the most their squared terms
    can move together (``vapor_switch_set``)."""
    near, size = vapor_switch_set(engine, scfg, primal, tang, with_clip, eps, bound_eps)
    return int(near.sum()), float(size[near].double().sum())


def point_subset(ins, idx):
    """A residual or decode wrapper's point arguments at ``idx`` (a [3, N, ...] operand on its axis
    1); the weights, ``ins[0]``, as they are."""
    return (ins[0], *(x[:, idx].contiguous() if x.ndim == 3 else x[idx].contiguous() for x in ins[1:]))


def term_gradients(rk, primal, tang, cor, specs, with_clip: bool):
    """|d term_e / d output| of ``rk.residual_point_terms`` at one decode (``primal`` [N, 6], ``tang``
    [3, N, 6]), float64: [6, N, 6] and [6, 3, N, 6].  A point's terms depend on its own outputs only,
    so the gradient of an equation's sum over the points gives them all.  The vapor term's q_s,
    delta and F are detached there, as in training, and take no share."""
    g_ps, g_ts = [], []
    with torch.enable_grad():
        p64 = primal.detach().double().requires_grad_()
        t64 = tang.detach().double().requires_grad_()
        terms = rk.residual_point_terms(p64, t64, cor.double(), specs, with_clip)
        for e in range(terms.shape[0]):
            g_p, g_t = torch.autograd.grad(terms[e].sum(), (p64, t64), retain_graph=e < terms.shape[0] - 1,
                                           allow_unused=True)
            g_ps.append(torch.zeros_like(p64) if g_p is None else g_p.abs())
            g_ts.append(torch.zeros_like(t64) if g_t is None else g_t.abs())
    return torch.stack(g_ps), torch.stack(g_ts)


def decode_allowance(rk, primal, tang, k_primal, k_tang, cor, specs, with_clip: bool) -> torch.Tensor:
    """What the decode's own disagreement moves each point's terms by: [6, N] float64, for equation
    e and point n the sum over the point's 24 decode outputs of |d term_e / d output| x delta, where
    delta = |kernel decode - plain decode| of that output (``k_primal`` / ``primal`` [N, 6],
    ``k_tang`` / ``tang`` [3, N, 6]).  The derivative is the larger of its magnitudes at the two
    decodes (``term_gradients``): by the mean value theorem the change of a term is its gradient at a
    point between them times delta, and for the products, quotients and squares of the six equations
    that gradient lies within the larger of the two ends' on a segment this short."""
    d_p = (k_primal.double() - primal.double()).abs()
    d_t = (k_tang.double() - tang.double()).abs()
    (gp_a, gt_a), (gp_b, gt_b) = (term_gradients(rk, primal, tang, cor, specs, with_clip),
                                  term_gradients(rk, k_primal, k_tang, cor, specs, with_clip))
    return (torch.maximum(gp_a, gp_b) * d_p).sum(-1) + (torch.maximum(gt_a, gt_b) * d_t).sum((1, 3))


def residual_check(rk, engine, scfg, fns, ins, cor, with_clip: bool, dtype, rtol: float) -> dict:
    """One of phase 11's checks: a residual-sum kernel against its plain version on the points of
    ``ins`` (the wrapper's arguments up to the conditioning values), ``fns`` = (kernel, plain
    version, plain decode, the forward kernel whose bits the residual kernel's decode has).  Each
    equation e passes if |kernel - plain| <= rtol |plain| + allowance_e: the allowance is the sum
    over the points of ``decode_allowance``, the decode's own disagreement (the forward kernel's
    outputs against the plain decode's) carried through the term, the vapor sum's also the terms
    of its points near a switch (``vapor_switch_points``).  Also the decode's bits: at the three
    points that carry most of the largest allowance and at the first five, the kernel's term (a
    launch on the point alone) against the term of the forward kernel's decode and of the plain
    decode.  Returns the readings, the plain decode among them."""
    kernel_fn, plain_fn, decode_ref, decode_kernel = fns
    specs = scfg.obs_specs
    primal, tang = decode_ref(*ins, dtype)
    k_primal, k_tang = decode_kernel(*ins, dtype)
    got = kernel_fn(*ins, cor, specs, with_clip=with_clip, compute_dtype=dtype)
    again = kernel_fn(*ins, cor, specs, with_clip=with_clip, compute_dtype=dtype)
    torch.cuda.synchronize()
    want = plain_fn(*ins, cor, specs, with_clip=with_clip, compute_dtype=dtype)
    exact = rk.residual_point_terms(primal, tang, cor, specs, with_clip).double().sum(1)
    exact_k = rk.residual_point_terms(k_primal, k_tang, cor, specs, with_clip).double().sum(1)
    n_near, moved = vapor_switch_points(engine, scfg, primal, tang, with_clip, SWITCH_EPS[dtype], KINK_EPS)
    shares = decode_allowance(rk, primal, tang, k_primal, k_tang, cor, specs, with_clip)
    allowance = shares.sum(1).tolist()
    extra = [a + (moved if e == 4 else 0.0) for e, a in enumerate(allowance)]
    got_l, want_l = got.tolist(), want.tolist()
    ok = [abs(g - w) <= rtol * abs(w) + x for g, w, x in zip(got_l, want_l, extra)]
    top = {e: torch.topk(shares[e], min(3, shares.shape[1])).indices.tolist() for e in range(6)}
    widest = max(range(6), key=lambda e: allowance[e] / (rtol * abs(want_l[e])) if want_l[e] else 0.0)
    sample = sorted(set(top[widest]) | set(range(min(5, primal.shape[0]))))
    k_terms = rk.residual_point_terms(k_primal[sample], k_tang[:, sample], cor[sample], specs, with_clip)
    p_terms = rk.residual_point_terms(primal[sample], tang[:, sample], cor[sample], specs, with_clip)
    bits_equal = plain_equal = 0
    for j, i in enumerate(sample):
        alone = kernel_fn(*point_subset(ins, [i]), cor[[i]].contiguous(), specs, with_clip=with_clip,
                          compute_dtype=dtype)
        bits_equal += torch.equal(alone, k_terms[:, j])
        plain_equal += torch.equal(alone, p_terms[:, j])
    phys, _ = engine.packed_physical_from_primal_tangents(primal, tang, specs, with_clip)
    return dict(got=got, again=again, want=want, exact=exact, exact_k=exact_k, n_near=n_near, moved=moved,
                allowance=allowance,
                extra=extra, ok=ok, top=top, phys=phys, sample=len(sample), bits_equal=bits_equal,
                plain_equal=plain_equal, primal=primal, tang=tang)


def allowance_text(check: dict, rtol: float) -> str:
    """A check's allowances beside the relative bound's part, per equation; where an allowance
    reaches a tenth of that part, the three points that carry most of it with their rho, T and p."""
    parts = []
    for e, (a, w) in enumerate(zip(check["allowance"], check["want"].tolist())):
        text = f"{EQUATION_SHORT[e]} {a:.3g} (bound's part {rtol * abs(w):.3g})"
        if a >= 0.1 * rtol * abs(w):
            phys = check["phys"]
            text += " at " + ", ".join(
                f"[{i}: rho {float(phys[5, i]):.4g}, T {float(phys[3, i]):.4g}, p {float(phys[2, i]):.6g}]"
                for i in check["top"][e])
        parts.append(text)
    return "; ".join(parts)


EQUATION_SHORT = ("mom_u", "mom_v", "cont", "energy", "vapor", "gas")


V2_ROUNDING_POINTS = ("T(p)", "T(t_k)", "T(c)", "T(t2_k)", "T(relu r)", "T(tr_k)")


def v2_rounding_reading(dk, w, pe, dpe, cd_pe, near, tol_primal: float, tol_tangent: float, w1k=None) -> dict:
    """The rounding the bf16 tensor-core v2 kernel follows, a reading held to nothing
    (csrc/decode_jvp_v2.cu): for each of the plain version's six bf16 rounding points, the chain
    with the sums that feed that point (alone) taken in float64 in place of cuBLAS's, from the same
    inputs: the elements that then round the other way, and the points whose primal moves past
    ``tol_primal`` (1 + its largest) or a tangent past ``tol_tangent`` of its largest, outside the
    kink set ``near`` [N].  Also whether cuBLAS sums c's two products and r's one add a term in k
    order.  ``pe`` [N, in_ch], ``dpe`` [3, N, ch], ``cd_pe`` [N, in_ch], ``w1k`` [V, 3, ch, hid] the
    tangent rows' weights (v2's ``slice_tangent_weights`` of ``w.w1`` when None; v3's are the
    channel-major ``w.w1`` in three blocks of rows); returns {point: (flips, points past)} and
    {sum: elements where cuBLAS is not that order}."""
    bf = torch.bfloat16
    with torch.no_grad():
        w1k = dk.slice_tangent_weights(w.w1) if w1k is None else w1k

        def dot32(x, y):
            return dk.dot_f32(x, y, bf)

        def dot64(x, y):
            return torch.matmul(x.to(bf).double(), y.to(bf).double()).float()

        def sequential(x, y):  # one add a term in k order from zero; bf16 products are exact in f32
            x, y = x.to(bf).float(), y.to(bf).float()
            s = x[..., :, 0:1] * y[..., 0:1, :]
            for k in range(1, x.shape[-1]):
                s = s + x[..., :, k:k + 1] * y[..., k:k + 1, :]
            return s

        def chain(at=None):
            """The plain version's chain (decode_jvp_v2_ref), the sums feeding ``at`` in float64;
            its values before each rounding and its outputs."""
            d = {q: dot64 if q == at else dot32 for q in V2_ROUNDING_POINTS}
            z = d["T(p)"](pe, w.w1) + w.b1[:, None, :]
            t = torch.stack([torch.where(z > 0, d["T(t_k)"](dpe[k], w1k[:, k]), 0.0) for k in range(3)])
            c = (d["T(c)"](torch.relu(z), w.w2) + w.b2[:, None, :]
                 + (d["T(c)"](cd_pe, w.wd) + w.bd[:, None, :]) + w.fh_add[:, None, :])
            t2 = d["T(t2_k)"](t, w.w2[None])
            r = d["T(relu r)"](c, w.f1) + w.g1[:, None, :]
            tr = torch.where((r > 0)[None], d["T(tr_k)"](t2, w.f1[None]), 0.0)
            wo = w.wo.to(bf).float()
            o = ((dot32(torch.relu(r), w.f2) + w.g2[:, None, :] + 2.0 * c) * wo[:, None, :]).sum(-1)
            to = ((dot32(tr, w.f2[None]) + 2.0 * t2) * wo[None, :, None, :]).sum(-1)
            vals = dict(zip(V2_ROUNDING_POINTS, (torch.relu(z), t, c, t2, torch.relu(r), tr)))
            return vals, o, to

        vals0, o0, to0 = chain()
        z0 = dot32(pe, w.w1) + w.b1[:, None, :]
        not_seq = {"T(p) . w2": int((sequential(torch.relu(z0), w.w2) != dot32(torch.relu(z0), w.w2)).sum()),
                   "cd . wd": int((sequential(cd_pe, w.wd) != dot32(cd_pe, w.wd)).sum()),
                   "T(c) . f1": int((sequential(vals0["T(c)"], w.f1) != dot32(vals0["T(c)"], w.f1)).sum())}
        reading = {}
        for q in V2_ROUNDING_POINTS:
            vals, o, to = chain(q)
            flips = int((vals[q].to(bf) != vals0[q].to(bf)).sum())
            past = ((o - o0).abs() > tol_primal * (1.0 + float(o0.abs().max()))).any(0)
            for k in range(3):
                past |= ((to[k] - to0[k]).abs() > tol_tangent * float(to0[k].abs().max())).any(0)
            reading[q] = (flips, int((past & ~near).sum()))
            del vals, o, to
        del vals0, o0, to0, z0
    torch.cuda.empty_cache()
    return reading, not_seq


def attention_ptxas(build_log: str):
    """(kernel, registers and spills) for each kernel of attention.cu in its ptxas -v report."""
    import re

    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '[^']*?(attention_(?:bf16|f32))ILi(\d+)ELb([01])E(?:Li(\d+)E)?", line)
        if m:
            name = (f"{m.group(1)}<E={m.group(2)}, {'flash' if m.group(3) == '1' else 'single-tile'}"
                    + (f", {16 * int(m.group(4))} rows a warp>" if m.group(4) else ">"))
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split(":", 1)[1].strip() + "; " + spills))
            name = None
    return out


def kernel_ptxas(build_log: str, kernel: str) -> str:
    """Registers, barriers and spills of the entry function whose mangled name holds ``kernel``
    in a ptxas -v report."""
    report, inside = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            report.append(line.split(":", 1)[-1].strip())
    return "; ".join(report) or "no ptxas report"


def variant_library(cuda_build, source: str, variant: str, header: str, old: str, new: str) -> ctypes.CDLL:
    """``source`` built from a copy of the sources (under the build directory, in ``variant``) in
    which ``header``'s text ``old`` is replaced by ``new``: a reading, never called by the port."""
    work = os.path.join(cuda_build.BUILD_DIR, variant)
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(cuda_build.CSRC_DIR):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
                text = f.read()
            if name == header:
                if old not in text:
                    raise AssertionError(f"{old!r} not found in {header}")
                text = text.replace(old, new)
            with open(os.path.join(work, name), "w") as f:
                f.write(text)
    so = os.path.join(work, os.path.splitext(source)[0] + ".so")
    res = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, os.path.join(work, source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant of {source}: {res.stderr[-2000:]}")
    return ctypes.CDLL(so)


def without_partial_atomics(cuda_build, source: str) -> ctypes.CDLL:
    """``source`` built from a copy of the sources in which the backward's partials skip their
    atomic adds (add_tile adds only a value that does not occur): a reading of what those adds
    cost, never called by the port."""
    add = "atomicAdd(reinterpret_cast<float4*>(at), v);"
    return variant_library(cuda_build, source, "without_partial_atomics", "decode_mma.cuh", add,
                           "if (v.x == 1.25e-37f) " + add)


# the encoder kernel's checks at the flagship's 287 tokens and at short lengths across the bf16 body's
# units (16-row groups, 32-query attention units)
ENC_SHORT_LENGTHS = (1, 15, 16, 17, 33)


def sm_clock_mhz() -> float:
    """The SM clock the card can reach (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def attention_bound(n: int, e: int, heads: int, nbytes: float) -> dict:
    """The attention kernels' least time, ms: the largest of FLOPs (4 L^2 E a head) over the
    bf16 peak, bytes over the memory rate, and exponentials (one a score, L^2 a head) over the
    special-function unit's rate at clocks.max.sm.  Exponentials and FLOPs are both operations."""
    props = torch.cuda.get_device_properties(0)
    exp_rate = SFU_EXP_PER_CLOCK_PER_SM * props.multi_processor_count * sm_clock_mhz() * 1e6
    terms = {"flops": 1e3 * 4.0 * n * n * e * heads / PEAK_BF16_FLOPS, "bytes": 1e3 * nbytes / PEAK_BYTES_PER_S,
             "exp": 1e3 * float(n) * n * heads / exp_rate}
    by = max(terms, key=terms.get)
    return dict(ms=terms[by], by="bytes" if by == "bytes" else "operations", term=by, terms=terms)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def encoder_close(got: torch.Tensor, want: torch.Tensor, dtype):
    """(max |got - want|, mean |got - want| in bf16 steps of the largest |want|, within the
    TOL_ENC bounds?)."""
    d = (got.float() - want.float()).abs()
    err, scale, step = float(d.max()), float(want.abs().max()), bf16_step(want.float())
    mean_steps = float(d.mean()) / step
    if dtype == torch.float32:
        return err, mean_steps, err <= TOL_ENC_F32 * (1.0 + scale)
    return err, mean_steps, err <= TOL_ENC_BF16_STEPS * step and mean_steps <= TOL_ENC_BF16_MEAN


def attention_phase(dev) -> dict:
    """Both attention kernels against their plain versions, bf16 and float32, at the sizes of
    ATTN_*_SIZES with the flagship's heads and at ATTN_OTHER_SIZES with the other head widths;
    FusedAttention with either kernel's forward against autograd of the plain forward.
    Returns the max errors by (kernel, dtype, tokens) for the flagship's heads, by (kernel,
    dtype, tokens, head width) for the others."""
    from deepphysinet_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(13)
    scale = 1.0 / ATTN_HEAD_DIM ** 0.5

    def qkv(n, dtype, count=3, e=ATTN_HEAD_DIM):
        return [torch.randn(1, n, ATTN_HEADS, e, generator=g).to(dev, dtype) for _ in range(count)]

    cases = [(e, dtype, wrapper, plain, n)
             for e, tile_sizes, flash_sizes in ((ATTN_HEAD_DIM, ATTN_TILE_SIZES, ATTN_FLASH_SIZES),
                                                *((e, ATTN_OTHER_SIZES, ATTN_OTHER_SIZES)
                                                  for e in ATTN_OTHER_HEAD_DIMS))
             for dtype in (torch.bfloat16, torch.float32)
             for wrapper, plain, sizes in ((at.attention_tile, at.attention_tile_ref, tile_sizes),
                                           (at.attention_flash, at.attention_flash_ref, flash_sizes))
             for n in sizes]
    errs = {}
    for e, dtype, wrapper, plain, n in cases:
        q, k, v = qkv(n, dtype, e=e)
        before = wrapper.launches
        got = wrapper(q, k, v, e ** -0.5)
        torch.cuda.synchronize()
        want = plain(q, k, v, e ** -0.5)
        err = float((got.float() - want.float()).abs().max())
        limit = (TOL_ATTN_F32 * (1.0 + float(want.float().abs().max())) if dtype == torch.float32
                 else bf16_step(want.float()))
        errs[(wrapper.__name__, dtype, n) if e == ATTN_HEAD_DIM else (wrapper.__name__, dtype, n, e)] = err
        plan = at.launch_plan(q, flash=wrapper is at.attention_flash)
        differ = float((got.float() != want.float()).float().mean())
        log(f"[attention] {wrapper.__name__:15s} {str(dtype):15s} E={e:2d} L={n:5d}: max|kernel-plain| {err:.3e} "
            f"(max|plain| {float(want.float().abs().max()):.3f}, bound {limit:.3e}; {differ:.2%} of the entries "
            f"differ); {plan['blocks']} blocks of "
            f"{plan['warps']} warps, {plan['smem_bytes']} B shared" + (", K and V resident" if plan["resident"] else ""))
        if not (wrapper.launches == before + 1 and got.shape == want.shape and got.dtype == dtype
                and bool(torch.isfinite(got).all()) and err <= limit):
            raise AssertionError(f"{wrapper.__name__} disagrees with its plain version ({dtype}, E={e}, L={n})")
    for impl, wrapper in (("pallas", at.attention_tile), ("flash", at.attention_flash)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g_out = qkv(287, dtype, count=4)

            def grads(fn):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                fn(*leaves).backward(g_out)
                return [t.grad.float() for t in leaves]

            before = wrapper.launches
            got = grads(lambda *a: at.fused_attention(*a, scale, impl))
            launched = wrapper.launches - before
            want = grads(lambda *a: at.attention_xla(*a, scale))
            rel = max(float((a_ - b_).abs().max()) / float(b_.abs().max()) for a_, b_ in zip(got, want))
            held = dtype == torch.float32
            log(f"[attention] FusedAttention(impl={impl!r}) {str(dtype):15s} L=287: {launched} kernel launch for "
                f"forward and backward; q, k, v gradients against autograd of the plain forward at most {rel:.2e} "
                f"of their largest entry" + (f" (bound {RTOL_ATTN_GRAD:.0e})" if held else
                                            " (bf16: JAX's rounding against autograd's, C14; not held)"))
            if launched != 1 or (held and rel > RTOL_ATTN_GRAD):
                raise AssertionError(f"FusedAttention(impl={impl!r}) disagrees with autograd of the plain forward")
    return errs


def encoder_phase(dev, model, field, fh_norm: float, reset_launch_counts) -> dict:
    """The fused encoder kernel against its plain version at flagship width, bf16 and float32,
    on the model's weights and embedded tokens; then encode_fused (two batch items, two
    launches) against PhysicsNet.encode.  Returns the errors and the launch count."""
    from deepphysinet_tpu_torch.ops import encoder_kernel as ek

    net = model.meta_net.model
    act = net.encoder.attn_layers[0].activation
    w = ek.extract_encoder_weights(model)
    fields = torch.cat([field.float(), field.float().roll(1, dims=1)])
    fh = torch.tensor([[fh_norm], [0.5 * fh_norm]], device=dev)
    with torch.no_grad():
        x = net.enc_embedding(fields, fh, net.learnable_token)[0]
    out = {"errs": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (x.shape[0],) + ENC_SHORT_LENGTHS:
            xn = x[:n].contiguous()
            route = ek.kernel_route(ek.cast_encoder_weights(w, dtype), n, dtype)
            before = ek.fused_encoder_forward.launches
            got = ek.fused_encoder_forward(w, xn, act, dtype)
            torch.cuda.synchronize()
            want = ek.fused_encoder_forward_ref(w, xn, act, dtype)
            err, mean_steps, ok = encoder_close(got, want, dtype)
            if n == x.shape[0]:
                out["errs"][dtype] = err
            log(f"[encoder] fused encoder kernel {str(dtype):15s} L={n:3d}: "
                + (f"tensor cores, heads padded to {route}" if route else "CUDA cores")
                + f"; max|kernel-plain| {err:.3e} (max|plain| {float(want.abs().max()):.3f}), mean {mean_steps:.3f} "
                f"bf16 steps of the largest (bounds: f32 {TOL_ENC_F32:.0e} x (1 + max); bf16 {TOL_ENC_BF16_STEPS} "
                f"steps, mean {TOL_ENC_BF16_MEAN} step)")
            # bf16 takes the tensor-core body at the flagship's widths, float32 the CUDA-core body
            if not (ok and got.shape == want.shape and bool(torch.isfinite(got).all())
                    and ek.fused_encoder_forward.launches == before + 1 and bool(route) == (dtype == torch.bfloat16)):
                raise AssertionError(f"the fused encoder kernel disagrees with its plain version ({dtype}, L={n})")
    reset_launch_counts()
    tokens = ek.encode_fused(model, fields, fh)
    torch.cuda.synchronize()
    out["launches"] = ek.fused_encoder_forward.launches
    with torch.no_grad():
        want = model.encode(fields, fh)
    err, mean_steps, ok = encoder_close(tokens, want, model.compute_dtype)
    log(f"[encoder] encode_fused against PhysicsNet.encode, {tuple(tokens.shape)}: max error {err:.3e}, mean "
        f"{mean_steps:.3f} bf16 steps of the largest token; {out['launches']} kernel launches (expected 2)")
    if not (ok and tokens.shape == want.shape and out["launches"] == 2):
        raise AssertionError("encode_fused disagrees with PhysicsNet.encode or did not launch once per batch item")
    return out


def paths_phase(dev, cfg, cd, window, dcfg, scfg, field, batch, launch_counts, reset_launch_counts,
                noise) -> dict:
    """The entry points with attn_impl='pallas' and 'flash' at flagship width, from the seeded
    weights: predict_grid against the default configuration's model, 3 PDE training steps under
    'pallas', and one PDE step's loss and gradients under 'pallas' against the default, with the
    configuration's compute type and with float32.  The single-tile kernel computes the plain
    path's function in another summation order, and the step's gradients amplify such last-bit
    changes of the encoder (C5, C6; in bf16 up to a parameter's own largest entry, C17).  So
    'pallas' is held to NOISE_TIMES times the larger of two samples of that noise: 'pallas' on
    the kernel's plain version (another summation order of the same function) against the
    default, and two runs of the default (the backward kernel's atomic adds); the parameters
    that hold noise (``noise``, from phase 6: the key-projection biases, C4) to ZERO_GRAD_NOISE
    of the gradient norm.  Returns the attention kernels' launch counts of these runs."""
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import attention as at
    from deepphysinet_tpu_torch.train import train_step as ts

    n_layers = int(cfg["meta_cfg"]["e_layers"])
    default_impl = cfg["train_cfg"]["tpu"].get("attn_impl")

    def fresh(impl, dtype=cd):
        return ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                     torch.Generator().manual_seed(0), compute_dtype=dtype, device=dev,
                                     attn_impl=impl)

    fh_norm = window.forecast_h / dcfg.forecast_time_period
    stds = np.array([s_.norm_factor[1] for s_ in dcfg.obs_specs])
    base = fresh(default_impl).model.eval()
    want_tokens = runner._encode(base, field, fh_norm)
    want_grid = runner.predict_grid(base, dcfg, window, field, window.forecast_h, 6.5)
    del base
    launches = {}
    for impl, name in (("pallas", "attention_tile"), ("flash", "attention_flash")):
        model = fresh(impl).model.eval()
        reset_launch_counts()
        grid = runner.predict_grid(model, dcfg, window, field, window.forecast_h, 6.5)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        launches[name] = counts.get(name, 0)
        tokens = runner._encode(model, field, fh_norm)
        t_err, t_mean, t_ok = encoder_close(tokens, want_tokens, cd)
        f_err = max(float(np.abs(grid[k] - want_grid[k]).max()) / stds[i] for i, k in enumerate(grid))
        f_limit = TOL_PATH_FIELDS * (1.0 + max(float(np.abs(want_grid[k]).max()) / stds[i]
                                              for i, k in enumerate(grid)))
        log(f"[paths] predict_grid with attn_impl={impl!r}: kernel launches {counts} (expected {n_layers} "
            f"{name}, 1 decode_primal_v4t); tokens against the default model's at most {t_err:.3e} (mean {t_mean:.3f} "
            f"bf16 steps of the largest; bounds as the encoder kernel's); fields at most {f_err:.3e} normalized units "
            f"(bound {f_limit:.3e})")
        bad = [k for k, a in grid.items() if a.shape != (145, 257) or not np.isfinite(a).all()]
        if bad or counts != {name: n_layers, "decode_primal_v4t": 1} or not t_ok or f_err > f_limit:
            raise AssertionError(f"predict_grid with attn_impl={impl!r}: launches {counts}, bad {bad}")
        del model

    # one PDE step's loss and gradients from the seeded state, 'pallas' against the default, with
    # the configuration's compute type and with float32
    def one_step(impl, dtype, tile=None):
        """``tile`` stands in for the single-tile kernel's wrapper when given."""
        wrapper = at.attention_tile
        at.attention_tile = tile or wrapper
        try:
            model = fresh(impl, dtype).model
            total, _ = ts.make_loss_fn(model, scfg)(batch, True)
            total.backward()
        finally:
            at.attention_tile = wrapper
        return float(total.detach()), {k: p_.grad.float() for k, p_ in model.named_parameters()}

    for dtype in dict.fromkeys((cd, torch.float32)):
        (l_p, g_p), (_, g_q) = one_step("pallas", dtype), one_step("pallas", dtype, at.attention_tile_ref)
        (l_x, g_x), (_, g_x2) = one_step(default_impl, dtype), one_step(default_impl, dtype)
        norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in g_x.values()])))
        noise_share = max(float(g[k].abs().max()) for g in (g_p, g_x) for k in noise) / norm

        def worst(a, b):
            rel = {k: float((a[k] - b[k]).abs().max()) / float(g_x[k].abs().max()) for k in a if k not in noise}
            top = max(rel, key=rel.get)
            return rel[top], top

        pallas_rel, plain_rel, rerun = worst(g_p, g_x), worst(g_q, g_x), worst(g_x2, g_x)
        rtol_grad = NOISE_TIMES * max(plain_rel[0], rerun[0])
        loss_rel = abs(l_p - l_x) / abs(l_x)
        log(f"[paths] one PDE step, {dtype} compute, attn_impl='pallas' against {default_impl!r}: total loss "
            f"{l_p:.8g} / {l_x:.8g} (relative {loss_rel:.1e}, bound {RTOL_VERSIONS_LOSS[dtype]:.0e}); per parameter "
            f"at most {pallas_rel[0]:.2e} of its largest gradient ({pallas_rel[1]}; bound {rtol_grad:.2e}, "
            f"{NOISE_TIMES:.0f} x the larger of 'pallas' on the kernel's plain version {plain_rel[0]:.2e} "
            f"({plain_rel[1]}) and run to run {rerun[0]:.2e} ({rerun[1]})); the {len(noise)} parameters that "
            f"hold noise at most {noise_share:.1e} of the gradient norm (bound {ZERO_GRAD_NOISE:.0e})")
        if not (loss_rel <= RTOL_VERSIONS_LOSS[dtype] and pallas_rel[0] <= rtol_grad
                and noise_share <= ZERO_GRAD_NOISE):
            raise AssertionError(f"one PDE step under attn_impl='pallas' disagrees with the default ({dtype})")
        del g_p, g_q, g_x, g_x2

    # three PDE training steps under 'pallas'
    state = fresh("pallas")
    step = ts.make_train_step(scfg)
    reset_launch_counts()
    for i in range(3):
        state, metrics = step(state, batch, True)
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        log(f"[paths] step {i} (pde, attn_impl='pallas'): total {metrics['total_loss']:.6g}, grad_norm "
            f"{metrics['grad_norm']:.6g}")
        if bad or metrics["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"train step under attn_impl='pallas': non-finite metrics {bad}")
    counts = {k: v for k, v in launch_counts().items() if v}
    want = {"attention_tile": 3 * n_layers, "fused_decode_jvp_v4s": 6, "decode_bwd_kernel_v4s": 6}
    log(f"[paths] kernel launches in 3 PDE steps under attn_impl='pallas': {counts} (expected {want})")
    if counts != want or state.step != 3:
        raise AssertionError(f"3 PDE steps under attn_impl='pallas' launched {counts}, not {want}")
    launches["attention_tile"] += counts["attention_tile"]
    return launches


DISK_HOURS = ("2008-01-01_06_00_00", "2008-01-01_11_00_00")  # six hours of the tree's first window
DISK_GEO = (72.0, 0.25, 0.0, 54.0, 0.0, -0.25)  # the study area's north-up geo-transform


def disk_phase(dev, cd, cfg, native, tmp: str):
    """Inference from disk at flagship width: a synthetic GeoTIFF tree (bbox 72-136 E, 18-54 N:
    labels 145 x 257, inputs 37 x 65, two init times) written with the port's generator, the
    seeded flagship model (phase 3's weights) saved with the port's ``save_checkpoint``, and the
    port's command line with ``--mode inference`` on six hours of the tree, through the primal
    kernel.  Every hour's exported T GeoTIFF is read back and held to the returned grid flipped
    north-up, with the study area's geo-transform; one hour is held to ``predict_grid``'s frame
    through the plain decode at phase 3's bound; the dataset's interpolation of that hour's grid
    goes through the native library (which must have been built) and is held to the window's numpy
    interpolation; and one hour is timed by host clock, split into its parts.  The tree and the
    checkpoint go into ``tmp``, where the trainer's phase finds them.  Returns the primal kernel's
    launches, the tree's paths and the checkpoint's directory."""
    import contextlib
    import datetime
    import io

    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.data.geotiff import read_tiff
    from deepphysinet_tpu_torch.data.synthetic import generate_synthetic_dataset
    from deepphysinet_tpu_torch.data.window import Window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import checkpoint as ckpt
    from deepphysinet_tpu_torch.train import train_step as ts
    from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack_t

    t0 = time.perf_counter()
    paths = generate_synthetic_dataset(os.path.join(tmp, "tree"), n_init_times=2, bbox=(72.0, 18.0, 136.0, 54.0))
    tree_s = time.perf_counter() - t0
    model = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                  torch.Generator().manual_seed(0), compute_dtype=cd, device=dev,
                                  attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl")).model
    model.eval()
    ckpt_dir, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
    ckpt.save_checkpoint(ckpt_dir, 0, 0, model, None, dx=float(cfg["train_cfg"]["dx"]),
                         dy=float(cfg["train_cfg"]["dy"]), pred_t_span=86400.0, obs_norm_cfg=cfg["obs_norm_cfg"])
    data = "train_cfg.valid_data."
    sets = [f"{data}input_path={paths['input_path']}", f"{data}label_path={paths['label_path']}",
            f"{data}constant_path={paths['constant_path']}", f"{data}in_coord_file={paths['in_coord_file']}",
            f"{data}out_coord_file={paths['out_coord_file']}",
            f"{data}input_data_map_cfg.NCEP={paths['input_map_file']}",
            f"{data}start_time=2008-01-01_00_00_00", f"{data}end_time=2008-01-02_00_00_00",
            f"inference_cfg.start_time={DISK_HOURS[0]}", f"inference_cfg.end_time={DISK_HOURS[1]}",
            "inference_cfg.log.with_vis=False", "inference_cfg.log.write_source=True",
            f"inference_cfg.log.vis_path={out}"]
    args = ["--config_file", FLAGSHIP_CFG, "--mode", "inference", "--checkpoints_path", ckpt_dir]
    for item in sets:
        args += ["--set", item]
    dk.decode_primal_v4t.launches = 0
    t0 = time.perf_counter()
    results = cli.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dk.decode_primal_v4t.launches
    chunks = -(-GRID_POINTS // runner._DECODE_CHUNK)
    log(f"[disk] tree of {sum(len(f) for _, _, f in os.walk(paths['input_path']))} input and "
        f"{len(os.listdir(paths['label_path']))} label GeoTIFFs written in {tree_s:.1f} s; the command line ran "
        f"{len(results)} hours in {run_s:.1f} s with {launches} primal kernel launches "
        f"(expected {chunks} a 40,960-point chunk x {len(results)} hours)")
    if len(results) != 6 or launches != chunks * len(results):
        raise AssertionError(f"inference from disk: {len(results)} hours, {launches} primal launches")
    exported = sorted(os.listdir(out))
    for hour, grids in results:
        stamp = (hour + datetime.timedelta(hours=6)).strftime("%Y-%m-%d_%H_%M_%S")
        img, geo = read_tiff(os.path.join(out, f"{stamp}_T.tiff"))
        if geo != DISK_GEO or not np.array_equal(img[:, :, 0], grids["T"][::-1]):
            raise AssertionError(f"the T GeoTIFF of {hour} is not the grid north-up with {DISK_GEO}: {geo}")
        if not all(a.shape == (145, 257) and np.isfinite(a).all() for a in grids.values()):
            raise AssertionError(f"the grids of {hour} are not finite 145 x 257 arrays")
    log(f"[disk] {len(exported)} GeoTIFFs exported ({exported[0]} .. {exported[-1]}); each read back equals its "
        f"hour's T grid flipped north-up, geo-transform {DISK_GEO}; mean T "
        + ", ".join(f"{g['T'].mean():.4g}" for _, g in results) + " K")

    # one hour against predict_grid's frame through the plain decode (phase 3's bound)
    full_cfg = copy.deepcopy(cfg)  # the configuration the command line ran
    cli.apply_overrides(full_cfg, sets)
    payload = ckpt.load_checkpoint(ckpt_dir)[0]
    ddcfg, ds = runner.inference_setup(full_cfg, payload)
    hour = datetime.datetime.strptime(DISK_HOURS[0], "%Y-%m-%d_%H_%M_%S")
    f, fh, off = runner.window_covering(ds, hour)
    window = Window.from_dataset(ds, f, labels=False)
    xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
    px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, off))
    fh_norm = float(fh) / ddcfg.forecast_time_period
    with torch.no_grad():
        tokens = runner._encode(model, torch.from_numpy(window.field[None]).to(dev), fh_norm)
        coords = torch.from_numpy(np.stack([px, py, pt], -1)).to(dev)
        weights, pe, _, cd_pe = engine._kernel_inputs(model, tokens, coords, torch.from_numpy(nwp).to(dev),
                                                      torch.tensor([fh_norm], device=dev), ddcfg.coord_spec)
        plain_norm = dk.decode_primal_v4t_ref(dk.fuse_decode_weights(weights), pe.to(cd), cd_pe.to(cd),
                                              torch.from_numpy(nwp).to(dev).t().contiguous(), cd)
        plain = inverse_norm_stack_t(plain_norm, ddcfg.obs_specs, with_clip=True).cpu().numpy()
    stds = np.array([sp.norm_factor[1] for sp in ddcfg.obs_specs])[:, None]
    frame = np.stack([results[0][1][k].reshape(-1) for k in ("u", "v", "P", "T", "q", "rio")])
    err = float((np.abs(frame - plain) / stds).max())
    limit = TOL[cd] * (1.0 + float(plain_norm.abs().max()))
    log(f"[disk] the hour {hour} against predict_grid's frame through the plain decode: max error {err:.3e} "
        f"normalized units (bound {limit:.3e})")
    if err > limit:
        raise AssertionError(f"inference from disk disagrees with the plain decode: {err} > {limit}")

    # the native library: the dataset's interpolation of the hour's grid against the window's numpy one
    if not native.available():
        raise AssertionError(f"the native host library did not build: {native.BUILD_ERROR}")
    t0 = time.perf_counter()
    nat = ds.get_margin_grid(f, xs.ravel(), ys.ravel(), np.full(xs.size, off))[3]
    nat_ms = 1e3 * (time.perf_counter() - t0)
    nat_err = float(np.abs(nat - nwp).max())
    log(f"[disk] native library {native.library_path()} built and ran: the dataset's trilinear interpolation "
        f"of the hour's {xs.size} points in {nat_ms:.1f} ms, max |native - numpy| {nat_err:.2e} (bound 1e-6); "
        "the inference path interpolates with the window's numpy (float64) version")
    if nat_err > 1e-6:
        raise AssertionError(f"native interpolation disagrees with numpy: {nat_err}")

    # one hour by host clock, split into its parts (the median of three after a warm-up)
    def hour_parts() -> dict:
        parts = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[name] = 1e3 * (time.perf_counter() - t)
            return r

        with contextlib.redirect_stdout(io.StringIO()):  # its metadata lines were logged above
            d = timed("dataset open", lambda: runner.inference_setup(full_cfg, payload)[1])
        w = timed("raster reads (tokens, NWP cube)", lambda: Window.from_dataset(d, f, labels=False))
        g = timed("conditioning", lambda: w.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, off)))
        tok = timed("encode", lambda: runner._encode(model, torch.from_numpy(w.field[None]).to(dev), fh_norm))
        phys = timed("decode", lambda: runner._decode_points(model, ddcfg, tok, g[0], g[1], g[2], g[3], fh_norm,
                                                             True).cpu().numpy())
        timed("export", lambda: runner.export_geotiff(os.path.join(tmp, "timed_T.tiff"),
                                                      phys[3].reshape(145, 257), d, ddcfg))
        return parts

    hour_parts()
    runs = [hour_parts() for _ in range(3)]
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    hour_ms = statistics.median(sum(r[k] for k in r if k != "dataset open") for r in runs)
    log(f"[disk] one hour by host clock, ms (median of 3): {hour_ms:.3f} without the dataset's open, split "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return launches, paths, ckpt_dir


# the trainer's phase: steps of its first run (from phase 19's seeded checkpoint) and of its resumed run,
# the first PDE step and the log cadence
TRAINER_STEPS, TRAINER_RESUMED_STEPS = 10, 2
TRAINER_PDE_START, TRAINER_LOG_STEP = 4, 5
TRAINER_META = ("dx", "dy", "dt", "pred_x_span", "pred_y_span", "pred_t_span", "label_time_step",
                "input_variable_cfg", "input_time_step", "input_time_step_nums", "obs_norm_cfg", "start_time",
                "end_time")


def logged_losses(log_dir: str) -> list:
    """The losses, gradient norms and validation losses of the trainer's log files in ``log_dir``."""
    import glob

    losses = []
    for path in sorted(glob.glob(os.path.join(log_dir, "log_*.txt"))):
        for line in open(path):
            fields = dict(f.split(":", 1) for f in line.strip().split(",") if ":" in f)
            losses += [float(fields[k]) for k in ("train loss", "margin_loss", "grad", "valid loss", "margin")
                       if k in fields]
    return losses


def trainer_phase(dev, cfg, paths, seed_ckpt: str, tmp: str, launch_counts, reset_launch_counts) -> dict:
    """Training from disk at flagship width through the port's command line (``--mode train``, in
    process): phase 19's tree (two windows an epoch) and its seeded model's checkpoint, the
    flagship's batch (20,480 + 4,096 points), loader workers (6) and engine, with ``--set`` for the
    tree's paths, no renders, ``pde_start_step`` ``TRAINER_PDE_START`` and ``log_step``
    ``TRAINER_LOG_STEP``: ``TRAINER_STEPS`` steps, then a resumed run of ``TRAINER_RESUMED_STEPS``
    more from the ``physics_latest`` it wrote, then ``--mode test`` (the full-grid RMSE, through the
    primal kernel) on the final checkpoint.  Holds: every logged loss finite; the v4s forward and
    backward launches to two a PDE step (margin and collocation points) plus two a PDE validation
    batch (forward only); the checkpoint's metadata bundle; the resumed run's first step at the
    saved step, with the scheduled rate of its epoch, the saved parameters bit for bit and an Adam
    step count equal to the steps taken; finite RMSEs with one primal launch a window's hour.  Times
    by host clock the first run's steps after the first (waiting on the loader, the copy to the
    device, the step, the metric fetch and validation of a log step, the epoch saves) and one
    window's item read alone, and says whether the loader keeps up with the step: each epoch's
    loader starts its two windows side by side, so the wait at an epoch's first step over two is
    what an item costs the workers.  Returns the launch counts."""
    import importlib.util
    import shutil
    import warnings

    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
    from deepphysinet_tpu_torch.interface import build as ibuild
    from deepphysinet_tpu_torch.interface import interface_physics as ip
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.train import checkpoint as ckpt
    from deepphysinet_tpu_torch.train.schedules import build_lr_schedule

    ckpt_dir, log_dir = os.path.join(tmp, "trainer_ckpt"), os.path.join(tmp, "trainer_log")
    shutil.copytree(seed_ckpt, ckpt_dir)  # the seeded weights at epoch 0, step 0, no optimizer state
    tree = {k: paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00"})  # both init times: two windows
    sets = [f"train_cfg.{split}.{k}={v}" for split, seed in (("train_data", 0), ("valid_data", 1))
            for k, v in {**tree, "seed": seed}.items()]
    sets += ["train_cfg.log.with_vis=False", f"train_cfg.log.log_step={TRAINER_LOG_STEP}",
             f"train_cfg.tpu.pde_start_step={TRAINER_PDE_START}"]
    base = ["--config_file", FLAGSHIP_CFG, "--checkpoints_path", ckpt_dir]
    for item in sets:
        base += ["--set", item]
    built, first = [], []
    build, make_step = ibuild.builder_models, ip.make_train_step

    def recording_build(*a, **k):  # the command line's interface, for its step clock
        built.append(build(*a, **k))
        return built[-1]

    def recording_make_step(scfg):  # each run's state at its first step, before the update
        inner = make_step(scfg)

        def step(state, batch, with_pde):
            if len(first) < len(built):
                first.append(dict(step=state.step, lr=[g["lr"] for g in state.optimizer.param_groups],
                                  adam=sorted({float(v["step"]) for v in state.optimizer.state.values()}),
                                  params={k: v.detach().clone() for k, v in state.model.state_dict().items()}))
            return inner(state, batch, with_pde)

        return step

    ibuild.builder_models, ip.make_train_step = recording_build, recording_make_step
    try:
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            state = cli.main(base + ["--mode", "train", "--max_steps", str(TRAINER_STEPS), "--log_path", log_dir])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        saved, next_epoch, saved_step = ckpt.load_checkpoint(ckpt_dir)
        t0 = time.perf_counter()
        resumed = cli.main(base + ["--mode", "train", "--max_steps", str(TRAINER_STEPS + TRAINER_RESUMED_STEPS),
                                   "--log_path", log_dir])
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        ibuild.builder_models, ip.make_train_step = build, make_step

    # every logged loss finite
    losses = logged_losses(log_dir)
    tb_missing = importlib.util.find_spec("tensorboardX") is None
    warned = any("tensorboardX unavailable" in str(w.message) for w in caught)
    log(f"[trainer] the command line trained {state.step} steps from phase 19's seeded checkpoint in {run_s:.1f} s, "
        f"then resumed from its physics_latest (epoch {next_epoch - 1}, step {saved_step}) for {resumed.step - state.step} "
        f"more in {resumed_s:.1f} s; {len(losses)} logged losses, grad norms and validation losses, all finite: "
        f"{all(np.isfinite(losses))}; tensorboardX {'missing, the summaries a no-op with its warning' if tb_missing else 'present'}")
    if not (losses and all(np.isfinite(losses))) or (tb_missing and not warned):
        raise AssertionError(f"trainer: logged losses {losses}, tensorboardX warning {warned}")
    if (state.step, saved_step, resumed.step) != (TRAINER_STEPS, TRAINER_STEPS, TRAINER_STEPS + TRAINER_RESUMED_STEPS):
        raise AssertionError(f"trainer: steps {state.step}, saved {saved_step}, resumed to {resumed.step}")

    # the launches: two forwards and two backwards a PDE step, two forwards a PDE validation batch
    steps = range(1, TRAINER_STEPS + TRAINER_RESUMED_STEPS + 1)
    pde = [s for s in steps if s - 1 >= TRAINER_PDE_START]
    logged = [s for s in steps if s % TRAINER_LOG_STEP == 1 or s in (TRAINER_STEPS, TRAINER_STEPS + TRAINER_RESUMED_STEPS)]
    want = (2 * len(pde) + 2 * len([s for s in logged if s in pde]), 2 * len(pde))
    got = (counts["fused_decode_jvp_v4s"], counts["decode_bwd_kernel_v4s"])
    others = {k: v for k, v in counts.items() if v and k not in ("fused_decode_jvp_v4s", "decode_bwd_kernel_v4s")}
    log(f"[trainer] v4s forward / backward kernel launches {got[0]} / {got[1]} (expected {want[0]} / {want[1]}: "
        f"{len(pde)} PDE steps x 2, and {want[0] - want[1]} forwards of {len(logged)} validation batches, "
        f"{(want[0] - want[1]) // 2} with the PDE terms); other kernels {others}")
    if got != want or others:
        raise AssertionError(f"trainer: v4s launches {got}, expected {want}; other kernels {others}")

    # the checkpoint and the resume
    missing = [k for k in TRAINER_META if k not in saved]
    schedule = build_lr_schedule(lr=float(cfg["train_cfg"]["optimizer"]["lr"]), **cfg["train_cfg"]["lr_schedule"])
    r = first[1]
    same = all(torch.equal(r["params"][k].cpu(), v) for k, v in saved["model"].items())
    log(f"[trainer] physics_latest: epoch {next_epoch - 1}, step {saved_step}, metadata bundle complete: {not missing}; "
        f"the resumed run's first step at step {r['step']}, rate {r['lr'][0]:.6g} (schedule of epoch {next_epoch}: "
        f"{schedule(next_epoch):.6g}), Adam step counts {r['adam']}, parameters bit-equal to the saved ones: {same}")
    if missing or r["step"] != saved_step or set(r["lr"]) != {schedule(next_epoch)} or r["adam"] != [float(saved_step)] \
            or not same:
        raise AssertionError(f"trainer: resume from {ckpt_dir} (missing metadata {missing}, first step {r['step']}, "
                             f"rates {r['lr']}, Adam steps {r['adam']}, parameters equal {same})")

    # --mode test on the final checkpoint: the full-grid RMSE through the primal kernel
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = cli.main(base + ["--mode", "test"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = launch_counts()["decode_primal_v4t"]
    rmse = {k: v for k, v in metrics.items() if k.startswith("rmse_")}
    hours = int(metrics["n_points"]) // GRID_POINTS
    log(f"[trainer] --mode test on the final checkpoint (step {metrics['global_step']:.0f}) in {test_s:.1f} s: "
        f"{metrics['n_windows']:.0f} windows, {hours} labelled hours, {test_launches} primal kernel launches; RMSE "
        + ", ".join(f"{k[5:]} {v:.4g}" for k, v in rmse.items()))
    if not (len(rmse) == 6 and all(np.isfinite(list(rmse.values()))) and test_launches == hours
            and metrics["global_step"] == TRAINER_STEPS + TRAINER_RESUMED_STEPS):
        raise AssertionError(f"trainer: --mode test gave {metrics} with {test_launches} primal launches")

    # the first run's steps by host clock (medians over the steps after the first), and one item alone
    clock = built[0].step_clock
    per_step = {k: statistics.median(clock[k][1:]) * 1e3 for k in ("copy", "step")}
    split_pde = {kind: statistics.median(clock["step"][i] * 1e3 for i in range(1, TRAINER_STEPS)
                                         if (i >= TRAINER_PDE_START) == is_pde)
                 for kind, is_pde in (("data-only", False), ("PDE", True))}
    windows = 2  # an epoch of the tree
    epoch_first = statistics.median(clock["loader"][i] * 1e3 for i in range(windows, TRAINER_STEPS, windows))
    within = statistics.median(clock["loader"][i] * 1e3 for i in range(1, TRAINER_STEPS, windows))
    tc = cfg["train_cfg"]
    data_cfg = dict(tc["train_data"], **{k: v for k, v in tree.items() if "." not in k},
                    input_data_map_cfg=dict(NCEP=paths["input_map_file"]))
    ds = PhysicsDataset(**data_cfg, input_variable_cfg=cfg["variable_cfg"], out_variable_cfg=cfg["obs_norm_cfg"],
                        dx=float(tc["dx"]), dy=float(tc["dy"]))
    item_ms = host_ms(lambda: ds[0])
    loader_ms = epoch_first / windows
    work_ms = per_step["copy"] + per_step["step"]
    log(f"[trainer] one step by host clock, ms (median of steps 2-{TRAINER_STEPS}): waiting on the loader at an "
        f"epoch's first step {epoch_first:.3f}, at its second {within:.3f}; copy to the device {per_step['copy']:.3f}; "
        f"the step {per_step['step']:.3f} (data-only {split_pde['data-only']:.3f}, PDE {split_pde['PDE']:.3f}); at a "
        f"log step the metric fetch {statistics.median(clock['fetch']) * 1e3:.3f} and the validation batch "
        f"{statistics.median(clock['valid']) * 1e3:.3f}; an epoch save {statistics.median(clock['save']) * 1e3:.3f} "
        f"(off the loop's thread but the last); {TRAINER_STEPS / run_s:.2f} steps/s over the run with its start-up")
    log(f"[trainer] the loader: one window's item (raster reads, point draws, interpolation) {item_ms:.3f} ms alone; "
        f"in the run, {tc['num_workers']} workers deliver an item every {loader_ms:.3f} ms (an epoch's first wait over "
        f"its {windows} windows) against {work_ms:.3f} ms of copy and step: the host loader "
        f"{'keeps up with' if loader_ms <= work_ms else 'does NOT keep up with'} the step")
    return dict(counts=counts, test_launches=test_launches,
                host=dict(loader_first=epoch_first, loader_later=within, copy=per_step["copy"], step=per_step["step"],
                          pde=split_pde["PDE"], fetch=statistics.median(clock["fetch"]) * 1e3,
                          pde_min=min(clock["step"][i] for i in range(TRAINER_PDE_START, TRAINER_STEPS)) * 1e3,
                          valid=statistics.median(clock["valid"]) * 1e3))


DEVICE_TRAINER_STEPS, DEVICE_POOL_STEPS, DEVICE_RESUMED_STEPS = 12, 6, 2  # six, three and one epochs


def v4s_launches_expected(first: int, last: int, pde_start: int = TRAINER_PDE_START) -> tuple:
    """(forward, backward) v4s launches of the trainer's steps first..last (1-based global steps,
    one run ending at ``last``, the PDE terms from step ``pde_start`` + 1): two forwards and two
    backwards a PDE step, two forwards a validation batch with the PDE terms (at each log step and
    the last)."""
    steps = range(first, last + 1)
    pde = [s for s in steps if s - 1 >= pde_start]
    logged = [s for s in steps if s % TRAINER_LOG_STEP == 1 or s == last]
    return 2 * len(pde) + 2 * len([s for s in logged if s in pde]), 2 * len(pde)


def device_trainer_phase(dev, cfg, paths, seed_ckpt: str, tmp: str, launch_counts, reset_launch_counts,
                         host: dict) -> dict:
    """Training with the points sampled on the device (``train_cfg.tpu.sample_mode=device``) through
    the command line, in process, on phase 19's tree (two windows) from its seeded checkpoint, at
    flagship width and batch (20,480 + 4,096 points, bf16), the train and valid data in memory (as
    the synthetic full-scale configurations set it), ``pde_start_step`` and ``log_step`` as phase
    20: (a) the iid sampler for ``DEVICE_TRAINER_STEPS`` steps (six epochs), (b) the pool sampler for
    ``DEVICE_POOL_STEPS``, (c) a resumed iid run of ``DEVICE_RESUMED_STEPS`` from the physics_latest
    that (a) wrote; after the launch counts are read, (d) run (a) again with no save until its
    last step, which shows what the epoch saves add to the steps beside them.  Holds:
    every logged loss finite; the v4s launches (two forwards and two
    backwards a PDE step, two forwards a PDE validation batch); each run's cube cache two builds,
    then hits only, and no failed validation; two validations with the same parameters identical;
    the resumed run's first step at the saved step.  On one sampled batch, on the card: the labels
    the label cube's rows at the drawn indices bit for bit; the conditioning against the host
    dataset's interpolation (float64) to float32 rounding; the pool's conditioning
    (``attach_pool_nwp``) the per-step interpolator's on the pool's points bit for bit; the draws
    uniform over x, y and slot (chi-squared, 20,480 draws, a fixed seed, p > 1e-6).  Prints by host
    clock a step split into waiting on the loader, the cube lookup or build, the step and the
    metric fetch, beside phase 20's host-sampled step, the loader wait in the first epoch against
    later ones, and by CUDA events the sampler alone (the draws and the gathers and
    interpolation of one step) of each sampler.  Returns the launch counts."""
    import glob
    import shutil

    from scipy import stats

    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.interface import build as ibuild
    from deepphysinet_tpu_torch.interface import interface_physics as ip
    from deepphysinet_tpu_torch.ops.interp import trilinear_interp_table_batched
    from deepphysinet_tpu_torch.train import checkpoint as ckpt
    from deepphysinet_tpu_torch.train import device_sampling as ds

    ckpt_dirs = {k: os.path.join(tmp, f"device_ckpt_{k}") for k in ("iid", "pool", "nosave")}
    log_dir = os.path.join(tmp, "device_log")
    for d in ckpt_dirs.values():
        shutil.copytree(seed_ckpt, d)
    tree = {k: paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00", "in_memory": True})
    sets = [f"train_cfg.{split}.{k}={v}" for split, seed in (("train_data", 0), ("valid_data", 1))
            for k, v in {**tree, "seed": seed}.items()]
    sets += ["train_cfg.log.with_vis=False", f"train_cfg.log.log_step={TRAINER_LOG_STEP}",
             f"train_cfg.tpu.pde_start_step={TRAINER_PDE_START}", "train_cfg.tpu.sample_mode=device"]

    def args(run, sampler, steps, extra=()):
        out = ["--config_file", FLAGSHIP_CFG, "--checkpoints_path", ckpt_dirs[run], "--mode", "train",
               "--max_steps", str(steps), "--log_path", log_dir, "--set", f"train_cfg.tpu.ds_sampler={sampler}"]
        for item in (*sets, *extra):
            out += ["--set", item]
        return out

    built, first = [], []
    build, make_step = ibuild.builder_models, ds.make_device_sampling_train_step

    def recording_build(*a, **k):  # the command line's interface: its clock, caches and validation
        built.append(build(*a, **k))
        return built[-1]

    def recording_make_step(step_cfg, scfg):  # each run's state at its first step
        inner = make_step(step_cfg, scfg)

        def step(state, batch, draws, with_pde):
            if len(first) < len(built):
                first.append(dict(step=state.step, device=batch.field.device, draws=draws.mx.device))
            return inner(state, batch, draws, with_pde)

        return step

    ibuild.builder_models, ds.make_device_sampling_train_step = recording_build, recording_make_step
    times = {}
    try:
        reset_launch_counts()
        for name, run, sampler, steps, extra in (
                ("iid", "iid", "iid", DEVICE_TRAINER_STEPS, ()), ("pool", "pool", "pool", DEVICE_POOL_STEPS, ()),
                ("resumed", "iid", "iid", DEVICE_TRAINER_STEPS + DEVICE_RESUMED_STEPS, ()),
                # (d), after the counts: run (a) again with no save until its last step, where
                # (a) saves after each epoch while the next one's steps run
                ("nosave", "nosave", "iid", DEVICE_TRAINER_STEPS, ("train_cfg.checkpoints.save_step=1000",))):
            if name == "nosave":
                counts = launch_counts()
            t0 = time.perf_counter()
            state = cli.main(args(run, sampler, steps, extra))
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0, state)
    finally:
        ibuild.builder_models, ds.make_device_sampling_train_step = build, make_step
    runs = dict(zip(("iid", "pool", "resumed", "nosave"), built))

    # every logged loss finite, the steps, the resume
    losses = []
    for path in sorted(glob.glob(os.path.join(log_dir, "log_*.txt"))):
        for line in open(path):
            fields = dict(f.split(":", 1) for f in line.strip().split(",") if ":" in f)
            losses += [float(fields[k]) for k in ("train loss", "margin", "grad", "valid loss") if k in fields]
    steps = [times[k][1].step for k in ("iid", "pool", "resumed", "nosave")]
    want_steps = [DEVICE_TRAINER_STEPS, DEVICE_POOL_STEPS, DEVICE_TRAINER_STEPS + DEVICE_RESUMED_STEPS,
                  DEVICE_TRAINER_STEPS]
    _, next_epoch, saved_step = ckpt.load_checkpoint(ckpt_dirs["iid"])
    log(f"[device trainer] the command line trained {steps[0]} steps (iid) in {times['iid'][0]:.1f} s and {steps[1]} "
        f"(pool) in {times['pool'][0]:.1f} s, then resumed the iid run for {steps[2] - steps[0]} more in "
        f"{times['resumed'][0]:.1f} s (first step at step {first[2]['step']}); cubes and draws on "
        f"{first[0]['device']} / {first[0]['draws']}; {len(losses)} logged losses, grad norms and validation "
        f"losses, all finite: {bool(losses) and all(np.isfinite(losses))}")
    if not (losses and all(np.isfinite(losses))) or steps != want_steps or first[2]["step"] != DEVICE_TRAINER_STEPS \
            or saved_step != steps[2] or any(f["device"] != dev or f["draws"] != dev for f in first):
        raise AssertionError(f"device trainer: losses {losses}, steps {steps}, first steps {first}, saved {saved_step}")

    # the launches: from counts of 0 before run (a) to after run (c)
    want = [sum(x) for x in zip(v4s_launches_expected(1, DEVICE_TRAINER_STEPS),
                                v4s_launches_expected(1, DEVICE_POOL_STEPS),
                                v4s_launches_expected(DEVICE_TRAINER_STEPS + 1,
                                                      DEVICE_TRAINER_STEPS + DEVICE_RESUMED_STEPS))]
    got = [counts["fused_decode_jvp_v4s"], counts["decode_bwd_kernel_v4s"]]
    others = {k: v for k, v in counts.items() if v and k not in ("fused_decode_jvp_v4s", "decode_bwd_kernel_v4s")}
    # the caches: each run builds its two windows once (train) and its two valid windows once
    caches = {k: (r.device_sampling.cubes.builds, r.device_sampling.cubes.hits, r._valid_cubes.builds,
                  r._valid_cubes.hits, r.valid_failures) for k, r in runs.items()}
    log(f"[device trainer] v4s forward / backward kernel launches {got[0]} / {got[1]} (expected {want[0]} / "
        f"{want[1]}); other kernels {others}; cube caches (train builds, hits, valid builds, hits, failed "
        f"validations): {caches}")
    run_steps = dict(iid=DEVICE_TRAINER_STEPS, pool=DEVICE_POOL_STEPS, resumed=DEVICE_RESUMED_STEPS,
                     nosave=DEVICE_TRAINER_STEPS)
    if got != want or others or any(c[0] != 2 or c[1] != run_steps[k] - 2 or c[2] > 2 or c[4]
                                    for k, c in caches.items()):
        raise AssertionError(f"device trainer: launches {got}, expected {want}; others {others}; caches {caches}")

    # two validations with the same parameters, and one sampled batch read back on the card
    iface, state = runs["iid"], times["iid"][1]
    sampled = iface.device_sampling
    n_windows, cache_cap = len(iface._dataset(iface.train_cfg["train_data"])), sampled.cubes.cap
    scfg, step_cfg, coord = sampled.scfg, sampled.cfg, sampled.cfg.coord_spec
    valid_ds = iface._dataset(iface.train_cfg["valid_data"])
    vals = []
    for _ in range(2):
        iface._valid_item = 0
        vals.append(iface._device_mode_validation(valid_ds, step_cfg, scfg, state, True))
    train_ds = iface._dataset(iface.train_cfg["train_data"])
    item = train_ds.get_cube_item(0)
    cube = sampled.cubes.get((item["input_file"],), lambda: None)
    Hl, Wl, Tl = ds.label_grid_dims(scfg, coord)
    cdims = ds.coarse_grid_dims(scfg, coord)
    with torch.no_grad():
        draws = ds.draw_points(torch.Generator(device=dev).manual_seed(2026), 1, scfg, coord)
        margin, inter = ds.sample_window_points_batched(draws, cube.nwp_cube, cube.label_cube, scfg, coord)
        labels_exact = torch.equal(margin.labels[0], cube.label_cube.view(Hl, Wl, Tl, -1)[draws.my[0], draws.mx[0],
                                                                                         draws.slot[0]])
        chi = {k: float(stats.chisquare(torch.bincount(getattr(draws, k)[0], minlength=n).cpu().numpy()).pvalue)
               for k, n in (("mx", Wl), ("my", Hl), ("slot", Tl))}
        # the points' coordinates as the sampler forms them (float32), interpolated on the host in float64
        coords = (((scfg.begin_lon + draws.mx[0] * scfg.fine_step).float(),
                   (scfg.begin_lat + draws.my[0] * scfg.fine_step).float(),
                   (draws.slot[0] * scfg.label_time_step).float(), margin),
                  (scfg.begin_lon + draws.ix[0] * (Wl - 1) * scfg.fine_step,
                   scfg.begin_lat + draws.iy[0] * (Hl - 1) * scfg.fine_step, draws.it[0].float(), inter))
        cond_err = 0.0
        for lon, lat, t_h, pts in coords:
            host_cond = train_ds._interp_cube_at(item["nwp_cube"], *(a.double().cpu().numpy() for a in (lon, lat, t_h)))
            err = np.abs(pts.nwp[0].double().cpu().numpy() - host_cond) / (1e-5 * (1.0 + np.abs(host_cond)))
            cond_err = max(cond_err, float(err.max()))
        pool_cube = runs["pool"].device_sampling.cubes.get((item["input_file"],), lambda: None)
        mx, my, slot = ds._decode_pool_idx(pool_cube.pool_idx[0].long(), scfg, coord)
        per_step = trilinear_interp_table_batched(
            pool_cube.nwp_cube, cdims, (scfg.begin_lon + mx * scfg.fine_step).float()[None],
            (scfg.begin_lat + my * scfg.fine_step).float()[None], (slot * scfg.label_time_step).float()[None],
            **ds._interp_kw(scfg))
        pool_exact = torch.equal(per_step[0], pool_cube.pool_nwp[0])
    log(f"[device trainer] two validations with the same parameters identical: {vals[0] == vals[1]} (valid loss "
        f"{vals[0]['total_loss']:.6g}); one sampled batch ({scfg.n_margin} + {scfg.n_inter} points): the labels the "
        f"label cube's rows at the drawn indices bit for bit: {labels_exact}; the conditioning against the host "
        f"dataset's float64 interpolation at most {cond_err:.3f} of the bound 1e-5 (1 + |host|); the pool's "
        f"conditioning the per-step interpolator's on its {pool_cube.pool_idx.shape[1]} points bit for bit: "
        f"{pool_exact}; chi-squared p of x, y, slot: " + ", ".join(f"{k} {v:.3g}" for k, v in chi.items()))
    if not (vals[0] is not None and vals[0] == vals[1] and labels_exact and cond_err <= 1.0 and pool_exact
            and min(chi.values()) > 1e-6):
        raise AssertionError(f"device trainer: validations {vals}, labels {labels_exact}, conditioning {cond_err}, "
                             f"pool {pool_exact}, chi-squared {chi}")

    # by host clock (medians over the steps after the first), and the sampler alone by CUDA events
    def med(xs):
        return statistics.median(xs) * 1e3 if xs else float("nan")

    split = {}
    for name in ("iid", "pool", "nosave"):
        clock = runs[name].step_clock
        n = len(clock["step"])
        split[name] = dict(loader_first=med(clock["loader"][:2]), loader_later=med(clock["loader"][2:]),
                           cube_build=med(clock["cube"][:2]), cube_hit=med(clock["cube"][2:]),
                           step=med(clock["step"][1:]), pde=med(clock["step"][TRAINER_PDE_START:n]),
                           pde_min=min(clock["step"][TRAINER_PDE_START:n]) * 1e3, fetch=med(clock["fetch"]),
                           # an epoch is two steps: its first follows the last epoch's save (off the loop's
                           # thread, which the host loader's wait hides in phase 20), its second does not
                           pde_first=med([clock["step"][i] for i in range(TRAINER_PDE_START, n) if i % 2 == 0]),
                           pde_second=med([clock["step"][i] for i in range(TRAINER_PDE_START, n) if i % 2 == 1]),
                           valid_build=med(clock["valid"][:2]), valid=med(clock["valid"][2:]),
                           saves=len(clock["save"]), pde_steps=[v * 1e3 for v in clock["step"][TRAINER_PDE_START:n]])
    sampler_ms = {}
    for name in ("iid", "pool"):
        c = runs[name].device_sampling.cubes.get((item["input_file"],), lambda: None)
        g = torch.Generator(device=dev).manual_seed(7)

        def sample(c=c, g=g):
            return ds.sample_batch(c, ds.draw_points(g, 1, scfg, coord), scfg, coord, dev)

        sample()
        sampler_ms[name] = statistics.median(cuda_ms(sample, 20) for _ in range(3))
    # the step alone, outside the loop (no loader threads, no saves): the host-sampled step on the
    # flagship's synthetic batch (on the device already) and the device-sampled steps, in turns
    from deepphysinet_tpu_torch.data.window import synthetic_batch
    from deepphysinet_tpu_torch.train import train_step as ts

    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    host_step = ts.make_train_step(step_cfg)
    ds_step = ds.make_device_sampling_train_step(step_cfg, scfg)
    pool_cube = runs["pool"].device_sampling.cubes.get((item["input_file"],), lambda: None)
    g = torch.Generator(device=dev).manual_seed(11)
    kinds = dict(host=lambda: host_step(state, batch, True),
                 iid=lambda: ds_step(state, cube, ds.draw_points(g, 1, scfg, coord), True),
                 pool=lambda: ds_step(state, pool_cube, ds.draw_points(g, 1, scfg, coord), True))
    alone = {k: [] for k in kinds}
    for _ in range(6):
        for k, fn in kinds.items():
            alone[k].append(host_ms(fn))
    alone = {k: statistics.median(v[1:]) for k, v in alone.items()}
    log("[device trainer] one PDE step alone by host clock around a synchronize, ms (median of 5 after one, in "
        "turns, from run (a)'s state): " + ", ".join(f"{k} {v:.3f}" for k, v in alone.items())
        + " (host: the synthetic batch already on the device)")
    for name in ("iid", "pool"):
        sp = split[name]
        log(f"[device trainer] {name}: one step by host clock, ms (medians): waiting on the loader in the first epoch "
            f"{sp['loader_first']:.3f}, in later epochs {sp['loader_later']:.3f}; the cube "
            f"{sp['cube_build']:.3f} built, {sp['cube_hit']:.3f} from the cache; the step {sp['step']:.3f} (PDE "
            f"{sp['pde']:.3f}, least {sp['pde_min']:.3f}; an epoch's first step {sp['pde_first']:.3f}, its second "
            f"{sp['pde_second']:.3f}); at a log step the validation {sp['valid_build']:.3f} with its "
            f"window's cube built, {sp['valid']:.3f} from the cache, and the metric fetch {sp['fetch']:.3f}; "
            f"the sampler alone (draws, gathers, interpolation; CUDA events) {sampler_ms[name]:.3f}, "
            f"{100 * sampler_ms[name] / sp['pde']:.1f}% of a PDE step; with {n_windows} windows, all held in the "
            f"{cache_cap}-window cube cache, the loop "
            f"{'still waits' if sp['loader_later'] > 0.1 * sp['step'] else 'no longer waits'} on its loader "
            f"(an epoch of more windows than the cache builds every cube it meets)")
    sp, sa = split["nosave"], split["iid"]
    if sp["saves"] != 1:
        raise AssertionError(f"device trainer: run (d) saved {sp['saves']} times, expected once, at its end")
    log(f"[device trainer] run (a) again with no save until its last step (d; {sp['saves']} save against "
        f"{sa['saves']} in (a)): the PDE step {sp['pde']:.3f} (an epoch's first {sp['pde_first']:.3f}, "
        f"its second {sp['pde_second']:.3f}) against (a)'s {sa['pde']:.3f} ({sa['pde_first']:.3f}, "
        f"{sa['pde_second']:.3f}) and the step alone {alone['iid']:.3f}; the PDE steps in order, ms: (a) "
        + " ".join(f"{v:.1f}" for v in sa["pde_steps"]) + "; (d) " + " ".join(f"{v:.1f}" for v in sp["pde_steps"]))
    log(f"[device trainer] beside phase 20's host-sampled step, ms: loader wait at an epoch's first step "
        f"{host['loader_first']:.3f}, at its second {host['loader_later']:.3f} (device-sampled, later epochs: iid "
        f"{split['iid']['loader_later']:.3f}, pool {split['pool']['loader_later']:.3f}); copy {host['copy']:.3f} "
        f"against the cube from the cache {split['iid']['cube_hit']:.3f}; the PDE step {host['pde']:.3f} (least "
        f"{host['pde_min']:.3f}) against {split['iid']['pde']:.3f} ({split['iid']['pde_min']:.3f}, iid) and "
        f"{split['pool']['pde']:.3f} ({split['pool']['pde_min']:.3f}, pool); the validation batch {host['valid']:.3f} "
        f"against {split['iid']['valid']:.3f} (iid, from the cache)")
    return dict(counts=counts, split=split, sampler_ms=sampler_ms, alone=alone)


TOOLS_WINDOWS = 2  # phase 19's tree: both init times
TOOLS_STATIONS = ("name,lon,lat,t_hours\n"  # on and off the 0.25-degree lattice; one fractional hour, one every hour
                  "on_grid,100.0,36.0,6\nhalf_cell,88.125,30.375,\nfractional,121.37,44.61,13.75\n"
                  "corner,136.0,54.0,0\n")


def tools_phase(dev, cd, cfg, paths, ckpt_dir: str, tmp: str, launch_counts, reset_launch_counts) -> dict:
    """The port's command-line tools (``deepphysinet_tpu_torch/tools/``), each ``main(argv)`` called in
    process on phase 19's tree (both windows) and the checkpoint that phase 20 trained, as a user
    would call them on the flagship configuration (``--set`` for the tree's paths):

    * ``evaluate --off_lattice``: its metrics finite, one primal launch a (slot, on/off) decode; the
      tree's generator defaults equal the evaluator's ``synth_start`` and ``synth_seed``; ``_truth_at``
      against the tree's label rasters at lattice points and labelled hours (rtol 2e-4, atol 1e-5 on
      the normalized-back labels, as the JAX test); one window's off-lattice decode through the
      kernel (``collapsed_decode``) against ``decode_primal_v4t_ref`` on the same inputs, at phase 3's
      bound;
    * ``evaluate --full_grid --per_lead``, ``--residuals`` and the subsampled mode: finite metrics,
      25 primal (full grid) or 25 v4t (residuals) launches a window, none in the subsampled mode
      (its plain per-variable decode); ``--residuals --save_maps`` raises, naming matplotlib;
    * ``infer_stations`` on a CSV written here (on- and off-grid stations, one at a fractional hour,
      one at every hour): the row count, one primal launch a window, and each row bit for bit
      against ``predict_points`` on the same queries;
    * ``derive_products --vs_model`` (no ``--vis``: no matplotlib): every written GeoTIFF read back,
      finite statistics, one primal launch.

    Each tool's host-clock seconds go on a line of their own.  Returns the tools' launches of the
    primal, v4t and v4 kernels."""
    import argparse
    import contextlib
    import csv
    import datetime
    import importlib.util
    import inspect
    import io

    from deepphysinet_tpu_torch.data.geotiff import read_full_image
    from deepphysinet_tpu_torch.data.synthetic import generate_synthetic_dataset
    from deepphysinet_tpu_torch.data.window import Window
    from deepphysinet_tpu_torch.eval import offlattice
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.ops.interp import trilinear_interp_cube
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.tools import build_interface, derive_products, evaluate, infer_stations

    tree = {k: paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00"})
    base = ["--config_file", FLAGSHIP_CFG]
    for split in ("train_data", "valid_data"):
        for k, v in tree.items():
            base += ["--set", f"train_cfg.{split}.{k}={v}"]
    seconds, launches = {}, {}

    def run(name, module, argv):
        """One tool in process, its output kept quiet; returns its result and its kernel launches."""
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = module.main(base + argv)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in launch_counts().items() if v}
        return out

    def expect(name, want):
        if launches[name] != want:
            raise AssertionError(f"tools: {name} launched {launches[name]}, expected {want}")

    def finite(name, metrics):
        bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)}
        if bad:
            raise AssertionError(f"tools: {name} gave non-finite metrics {bad}")

    # ---- evaluate --off_lattice
    gen = inspect.signature(generate_synthetic_dataset).parameters
    ev = inspect.signature(offlattice.evaluate_offlattice).parameters
    if (gen["start"].default, gen["seed"].default) != (ev["synth_start"].default, ev["synth_seed"].default):
        raise AssertionError(f"tools: the generator's defaults ({gen['start'].default}, {gen['seed'].default}) are "
                             f"not the evaluator's ({ev['synth_start'].default}, {ev['synth_seed'].default})")
    off = run("evaluate --off_lattice", evaluate, ["--checkpoint", ckpt_dir, "--off_lattice"])
    times = ev["times_per_window"].default
    expect("evaluate --off_lattice", {"decode_primal_v4t": TOOLS_WINDOWS * times * 2})
    finite("evaluate --off_lattice", off)
    log(f"[tools] evaluate --off_lattice on the {TOOLS_WINDOWS} windows, phase 20's checkpoint (step "
        f"{off['global_step']}): {off['n_points']:.0f} paired points, "
        + ", ".join(f"{k} {off['rmse_' + k]:.4g} / {off['rmse_' + k + '_ongrid']:.4g} (ratio {off['ratio_' + k]:.3f})"
                    for k in offlattice.VAR_NAMES)
        + f"; {launches['evaluate --off_lattice']['decode_primal_v4t']} primal launches (one a slot and set); "
          f"the tree's generator and the evaluator both start at {ev['synth_start'].default}, seed "
          f"{ev['synth_seed'].default}")

    # the closed-form truth against the tree's labels, at lattice points and labelled hours; the dataset,
    # model and step configuration as the tools build them
    interface = build_interface(argparse.Namespace(config_file=FLAGSHIP_CFG, device=None,
                                                   overrides=[a for a in base[2:] if a != "--set"]))
    ds = interface._dataset(interface.train_cfg["valid_data"])
    model = interface.load_physics_net(ckpt_dir)[0]
    scfg = interface._step_cfg(float(ds.input_time_step * ds.input_time_step_nums * 3600), ds.forecast_time_period)
    specs = norm_specs_from_cfg(cfg["obs_norm_cfg"])
    rng = np.random.RandomState(22)
    truth_err = 0.0
    for f in ds.input_files:
        labels = ds.get_label_cube(f)
        _, date_str, fh, _ = ds._parse_item(f)
        base_h = (datetime.datetime.strptime(date_str, "%Y-%m-%d-%H-%M-%S")
                  - datetime.datetime(2008, 1, 1)).total_seconds() / 3600.0 + fh
        xs, ys = rng.randint(0, len(ds.out_lon), 256), rng.randint(0, len(ds.out_lat), 256)
        for slot in (0, 7, 24):
            truth = offlattice._truth_at(ds.begin_lon + xs * ds.fine_lon_step, ds.begin_lat + ys * ds.fine_lat_step,
                                         base_h + slot, 0)
            for i, key in enumerate(OBS_NAME_ORDER):
                mean, std = specs[key].norm_factor
                lab = labels[i, ys, xs, slot].astype(np.float64) * std + mean
                excess = np.abs(lab - truth[:, i]) - (1e-5 + 2e-4 * np.abs(truth[:, i]))
                truth_err = max(truth_err, float(excess.max()))
    log(f"[tools] _truth_at against the tree's label rasters at 256 lattice points and hours 0, 7, 24 of each "
        f"window: largest excess over rtol 2e-4, atol 1e-5: {truth_err:.3e} (must be <= 0)")
    if truth_err > 0:
        raise AssertionError(f"tools: the closed-form truth disagrees with the tree's labels by {truth_err}")

    # one window's off-lattice decode through the kernel against the plain decode on the same inputs
    window = Window.from_dataset(ds, ds.input_files[0], labels=False)
    n = 5120
    xq, yq = rng.randint(0, len(ds.out_lon) - 1, n) + 0.5, rng.randint(0, len(ds.out_lat) - 1, n) + 0.5
    t_h = float(rng.randint(0, 24)) + 0.5
    with torch.no_grad():
        fh_norm = torch.tensor([window.forecast_h / ds.forecast_time_period], device=dev)
        tokens = model.encode(torch.from_numpy(window.field[None]).to(dev), fh_norm[None, :])[0]
        cube6 = torch.from_numpy(window.nwp_cube).to(dev)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        nwp = trilinear_interp_cube(cube6, put(ds.begin_lon + xq * ds.fine_lon_step),
                                    put(ds.begin_lat + yq * ds.fine_lat_step), put(np.full(n, t_h)),
                                    lon0=float(ds.in_lon[0]), dlon=float(ds.in_lon[1] - ds.in_lon[0]),
                                    lat0=float(ds.in_lat[0]), dlat=float(ds.in_lat[1] - ds.in_lat[0]),
                                    t0=0.0, dt=float(ds.input_time_step)).t()
        coords = torch.stack([put(xq * ds.dx), put(yq * ds.dy), put(np.full(n, t_h * 3600.0))], dim=-1)
        got = engine.collapsed_decode(model, tokens, coords, nwp, fh_norm, scfg.coord_spec)
        weights, pe, _, cd_pe = engine._kernel_inputs(model, tokens, coords, nwp, fh_norm, scfg.coord_spec,
                                                      tangents=False)
        want = dk.decode_primal_v4t_ref(dk.fuse_decode_weights(weights), pe, cd_pe, nwp.t().contiguous(), cd).t()
    err, limit = float((got - want).abs().max()), TOL[cd] * (1.0 + float(want.abs().max()))
    log(f"[tools] one window's off-lattice decode ({n} points at half-cell offsets, hour {t_h}) through the kernel "
        f"against the plain decode: max error {err:.3e} normalized units (bound {limit:.3e})")
    if not (torch.isfinite(got).all() and err <= limit):
        raise AssertionError(f"tools: the off-lattice decode disagrees with the plain decode: {err} > {limit}")

    # ---- evaluate's other modes
    full = run("evaluate --full_grid --per_lead", evaluate, ["--checkpoint", ckpt_dir, "--full_grid", "--per_lead"])
    expect("evaluate --full_grid --per_lead", {"decode_primal_v4t": 25 * TOOLS_WINDOWS})
    res = run("evaluate --residuals", evaluate, ["--checkpoint", ckpt_dir, "--residuals"])
    expect("evaluate --residuals", {"fused_decode_jvp_v4t": 25 * TOOLS_WINDOWS})
    sub = run("evaluate", evaluate, ["--checkpoint", ckpt_dir])
    expect("evaluate", {})
    for name, metrics in (("--full_grid", full), ("--residuals", res), ("subsampled", sub)):
        finite(f"evaluate {name}", metrics)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate.main(base + ["--checkpoint", ckpt_dir, "--residuals", "--save_maps", os.path.join(tmp, "maps")])
        maps_error = None
    except ImportError as e:
        maps_error = str(e)
    log(f"[tools] evaluate --full_grid --per_lead: {full['n_points']:.0f} points, RMSE "
        + ", ".join(f"{k} {full['rmse_' + k]:.4g}" for k in offlattice.VAR_NAMES)
        + f", {sum(1 for k in full if k.startswith('rmse_t2_f'))} leads; --residuals: weighted total "
          f"{res['weighted_total']:.4g}; subsampled: {sub['n_points']:.0f} points, RMSE t2 {sub['rmse_t2']:.4g}; "
          f"launches {launches['evaluate --full_grid --per_lead']} / {launches['evaluate --residuals']} / none; "
          f"--residuals --save_maps: {maps_error}")
    if importlib.util.find_spec("matplotlib") is None and (maps_error is None or "matplotlib" not in maps_error):
        raise AssertionError(f"tools: --save_maps without matplotlib did not name it: {maps_error}")

    # ---- infer_stations
    stations = os.path.join(tmp, "stations.csv")
    with open(stations, "w") as fp:
        fp.write(TOOLS_STATIONS)
    out_csv = os.path.join(tmp, "stations_out.csv")
    rows = run("infer_stations", infer_stations, ["--checkpoint", ckpt_dir, "--stations", stations, "--out", out_csv,
                                                   "--max_windows", str(TOOLS_WINDOWS)])
    expect("infer_stations", {"decode_primal_v4t": TOOLS_WINDOWS})
    with open(out_csv) as fp:
        written = list(csv.DictReader(fp))
    per_window = sum(1 if line.split(",")[3] else 25 for line in TOOLS_STATIONS.splitlines()[1:])
    keys = ("u10", "v10", "psfc", "t2", "q2", "rho")
    same = len(written) == len(rows) == TOOLS_WINDOWS * per_window
    for w in range(TOOLS_WINDOWS):
        wrows = written[w * per_window:(w + 1) * per_window]
        window = Window.from_dataset(ds, ds.input_files[w], labels=False)
        want = runner.predict_points(model, scfg, window, window.field[None], window.forecast_h,
                                     np.array([float(r["lon"]) for r in wrows]), np.array([float(r["lat"]) for r in wrows]),
                                     np.array([float(r["t_hours"]) for r in wrows]), device=dev)
        got = np.array([[np.float32(r[k]) for k in keys] for r in wrows], np.float32)
        same = same and np.array_equal(got, want)
    log(f"[tools] infer_stations: {len(written)} rows ({per_window} a window: a station without hours at each "
        f"of 25), {launches['infer_stations']} primal launches; every row bit for bit against predict_points on "
        f"the same queries: {same}")
    if not same:
        raise AssertionError("tools: infer_stations disagrees with predict_points")

    # ---- derive_products --vs_model
    out_dir = os.path.join(tmp, "products")
    summary = run("derive_products --vs_model", derive_products,
                  ["--vs_model", ckpt_dir, "--times", "1", "--output", out_dir,
                   "--products", "slp,t2,td2,u10m,v10m,rh_p850,wd10m,rh2"])
    expect("derive_products --vs_model", {"decode_primal_v4t": 1})
    tiffs = sorted(f for f in os.listdir(out_dir) if f.endswith(".tiff"))
    arrays = [read_full_image(os.path.join(out_dir, f)) for f in tiffs]
    stats = summary["vs_model"]["pairs"]
    nwp_grid = (1, len(ds.in_lat), len(ds.in_lon))
    ok = (len(tiffs) == summary["written"] == 8 and all(a.shape == nwp_grid and np.isfinite(a).all() for a in arrays)
          and sorted(stats) == ["t2", "wd10m"] and all(np.isfinite(v) for s in stats.values() for v in s.values()))
    log(f"[tools] derive_products --vs_model: {len(tiffs)} GeoTIFFs read back, finite {nwp_grid[1]} x {nwp_grid[2]} "
        f"rasters (the NWP grid); product "
        f"against model: " + "; ".join(f"{k} RMSE {s['rmse']:.4g}, bias {s['bias']:.4g}" for k, s in stats.items())
        + f"; {launches['derive_products --vs_model']} primal launch")
    if not ok:
        raise AssertionError(f"tools: derive_products wrote {tiffs}, stats {stats}")

    log("[tools] host clock, s: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return dict(launches=total, seconds=seconds)


ETL_STEPS = 6  # the ETL-built tree's training run: 3 epochs of its two windows, the PDE terms from step 5
ETL_HOURS = ("2008-01-01_06_00_00", "2008-01-01_07_00_00")  # the inference run's two hours
ETL_LOADER_ITEMS = 3  # loader items of each tree, alternating
GRIB_LEVELS = {"PSFC": ("sp", 0.0), "t2": ("t2m", 2.0), "u10": ("u10", 10.0), "v10": ("v10", 10.0),
               "UU": ("u", None), "VV": ("v", None), "TT": ("t", None), "GHT": ("gh", None), "QQ": ("q", None)}


def grib_half_quanta(path: str) -> dict:
    """{(init, lead, short name, level): half the packing quantum, 2^E / 10^D / 2} of each field of
    a GRIB2 file, E and D read from the field's own section 5."""
    import struct

    from deepphysinet_tpu_torch.data import grib2

    with open(path, "rb") as f:
        buf = f.read()
    halves, pos = [], 0
    while (pos := buf.find(b"GRIB", pos)) >= 0:
        p, end = pos + 16, pos + struct.unpack_from(">Q", buf, pos + 8)[0]
        while buf[p:p + 4] != b"7777":
            n, number = struct.unpack_from(">IB", buf, p)
            if number == 5:
                _, _, e, d, _ = grib2._parse_packing(buf[p:p + n])
                halves.append(2.0 ** e / 10.0 ** d / 2)
            p += n
        pos = end
    messages = grib2.read_messages(path)
    if len(messages) != len(halves):
        raise AssertionError(f"{path}: {len(messages)} fields, {len(halves)} data representation sections")
    return {(m.ref_time, m.forecast_hours, m.short_name, m.level): h for m, h in zip(messages, halves)}


def propagated(fn, values, allowances) -> np.ndarray:
    """max over the corners of the allowance box of |fn(values +- allowances) - fn(values)|: the
    first-order error of ``fn`` (monotone in each argument) from errors within ``allowances``."""
    import itertools

    base = fn(*values)
    worst = np.zeros_like(base)
    for signs in itertools.product((-1.0, 1.0), repeat=len(values)):
        worst = np.maximum(worst, np.abs(fn(*[v + s * a for v, s, a in zip(values, signs, allowances)]) - base))
    return worst


def ulp32(x) -> float:
    return float(np.spacing(np.float32(np.max(np.abs(x)))))


def rio_formula(p, t, q):
    return p / ((1 + 0.608 * q) * 287.0) / t  # tools/calc_rio.py


def etl_raster_errors(paths, etl_paths, grib_files, era5_files) -> dict:
    """Every raster of the ETL-built tree against phase 19's: {variable: (largest error, the error
    and the allowance where error / allowance is largest, that share)}, inputs and labels apart.  Inputs: half the GRIB packing
    quantum of the raster's message plus one float32 ulp (the reference value and the decoded value
    are each rounded to float32); labels: half the file's int16 ``scale_factor`` plus one ulp (the
    decode's float32 roundings); q2 and rio: those allowances carried through the dew point (or the
    gas law) to first order, plus the formula's float32 roundings."""
    import datetime
    import pickle

    from deepphysinet_tpu_torch.data.geotiff import read_full_image
    from deepphysinet_tpu_torch.data.netcdf_classic import NetCDFClassicFile
    from deepphysinet_tpu_torch.physics.thermo import dewpoint_from_specific_humidity, specific_humidity_from_dewpoint

    def raster(path):
        return read_full_image(path, as_rgb=False, normalize=False, data_format="NUMPY_FORMAT").astype(np.float64)

    worst = {}

    def hold(key, got, want, allowance):
        err = np.abs(got - want)
        shares = err / allowance
        i = np.unravel_index(np.argmax(shares), err.shape)
        largest = max(float(err.max()), worst.get(key, (0.0,))[0])
        if key not in worst or shares[i] > worst[key][3]:
            worst[key] = (largest, float(err[i]), float(np.broadcast_to(allowance, err.shape)[i]), float(shares[i]))
        else:
            worst[key] = (largest,) + worst[key][1:]

    halves = {}
    for path in grib_files:
        halves.update(grib_half_quanta(path))
    with open(paths["input_map_file"], "rb") as fp:
        index = pickle.load(fp)
    groups = sorted({k.rsplit("_", 1)[0] for k in index})  # GFS_<init>_f<lead>
    fmt = "%Y-%m-%d-%H-%M-%S"
    for group in groups:
        init, lead = datetime.datetime.strptime(group[4:23], fmt), int(group[-3:])
        ref = {v: raster(os.path.join(paths["input_path"], index[f"{group}_{v}"] + ".tiff"))
               for v in ("PSFC", "t2", "u10", "v10", "q2", "rio", "UU", "VV", "TT", "GHT", "QQ")}
        got = {v: raster(os.path.join(etl_paths["input_path"], index[f"{group}_{v}"] + ".tiff")) for v in ref}
        allow = {}
        for v in ("PSFC", "t2", "u10", "v10", "UU", "VV", "TT", "GHT", "QQ"):
            name, level = GRIB_LEVELS[v]
            levels = [level] if level is not None else [float(lv) for lv in (1000, 925, 850, 700, 500)]
            allow[v] = np.array([halves[(init, lead, name, lv)] + ulp32(ref[v][:, :, k])
                                 for k, lv in enumerate(levels)])
            hold(f"input {v}", got[v], ref[v], allow[v])
        td = dewpoint_from_specific_humidity(ref["PSFC"], ref["q2"])
        a_td = halves[(init, lead, "d2m", 2.0)] + ulp32(td)
        allow["q2"] = propagated(specific_humidity_from_dewpoint, (ref["PSFC"], td), (allow["PSFC"], a_td)) + ulp32(
            ref["q2"])
        hold("input q2", got["q2"], ref["q2"], allow["q2"])
        want_rio = rio_formula(*(ref[v].astype(np.float32) for v in ("PSFC", "t2", "q2")))
        a_rio = propagated(rio_formula, (ref["PSFC"], ref["t2"], ref["q2"]),
                           (allow["PSFC"], allow["t2"], allow["q2"])) + 4 * ulp32(want_rio)
        hold("input rio", got["rio"], want_rio, a_rio)

    half_scale = {}
    for path in era5_files:
        variables = NetCDFClassicFile(path).variables
        for hours in variables["time"][:]:
            t = datetime.datetime(1900, 1, 1) + datetime.timedelta(hours=int(hours))
            half_scale[t] = {k: float(variables[k].attributes["scale_factor"]) / 2
                             for k in ("sp", "t2m", "u10", "v10", "d2m")}
    for t, scales in sorted(half_scale.items()):
        stamp = t.strftime(fmt)
        ref = {v: raster(os.path.join(paths["label_path"], f"ERA5_{stamp}_{v}.tiff"))
               for v in ("PSFC", "t2", "u10", "v10", "q2", "rio")}
        got = {v: raster(os.path.join(etl_paths["label_path"], f"ERA5_{stamp}_{v}.tiff")) for v in ref}
        allow = {}
        for v, name in (("PSFC", "sp"), ("t2", "t2m"), ("u10", "u10"), ("v10", "v10")):
            allow[v] = scales[name] + ulp32(ref[v])
            hold(f"label {v}", got[v], ref[v], allow[v])
        td = dewpoint_from_specific_humidity(ref["PSFC"], ref["q2"])
        allow["q2"] = propagated(specific_humidity_from_dewpoint, (ref["PSFC"], td),
                                 (allow["PSFC"], scales["d2m"] + ulp32(td))) + ulp32(ref["q2"])
        hold("label q2", got["q2"], ref["q2"], allow["q2"])
        want_rio = rio_formula(*(ref[v].astype(np.float32) for v in ("PSFC", "t2", "q2")))
        a_rio = propagated(rio_formula, (ref["PSFC"], ref["t2"], ref["q2"]),
                           (allow["PSFC"], allow["t2"], allow["q2"])) + 4 * ulp32(want_rio)
        hold("label rio", got["rio"], want_rio, a_rio)
    return dict(worst=worst, input_groups=len(groups), label_hours=len(half_scale))


def etl_phase(dev, cfg, paths, seed_ckpt: str, tmp: str, launch_counts, reset_launch_counts) -> dict:
    """The ETL tools from raw archives to a tree, and the main path on that tree.  Phase 19's tree is
    written as users download it (``data/raw_archive.py``: one GRIB2 file an init time, ERA5 NetCDF-3
    files packed int16), ``tools.run_etl`` runs every tool's ``main(argv)`` in process into
    ``tmp/etl`` (phase 19's constants and coordinate pickles copied beside, which no tool makes), the
    label extraction runs again with two spawned workers (the same files byte for byte), and
    ``etl_raster_errors`` holds every raster to phase 19's.  Then the command line:
    ``--mode train`` from phase 19's seeded checkpoint for ``ETL_STEPS`` steps (the v4s launches as
    ``v4s_launches_expected``), ``--mode inference`` on ``ETL_HOURS`` (one primal launch an hour) and
    ``--mode test`` on the checkpoint the run saved (one primal launch a labelled hour).  Last, one
    ``PhysicsDataset`` item of the first window from each tree by host clock, alternating, and the
    tiles each decodes.  Returns the launch counts and the readings."""
    import datetime
    import filecmp
    import pickle
    import shutil

    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.data import geotiff
    from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
    from deepphysinet_tpu_torch.data.raw_archive import write_era5_netcdf, write_gfs_grib2
    from deepphysinet_tpu_torch.tools import extract_variable_from_ERA5, run_etl

    t_phase = time.perf_counter()
    raw = os.path.join(tmp, "etl_raw")
    grib_files = write_gfs_grib2(paths, os.path.join(raw, "grib"))
    era5_files = write_era5_netcdf(paths, os.path.join(raw, "era5"))
    raw_s = time.perf_counter() - t_phase
    root = os.path.join(tmp, "etl")
    etl = run_etl(os.path.join(raw, "grib"), os.path.join(raw, "era5"), root, datetime.datetime(2008, 1, 1),
                  datetime.datetime(2008, 1, 2), 24, 24)
    # C46: the label extraction again with two spawned workers writes the same files byte for byte
    t0 = time.perf_counter()
    pooled = extract_variable_from_ERA5.main(["--data_path", os.path.join(raw, "era5"), "--result_path",
                                              os.path.join(tmp, "etl_labels_2"), "--num_threads", "2",
                                              "--end_time", "2008-01-03-00:00:00"])
    pooled_s = time.perf_counter() - t0
    single = etl["results"]["extract_variable_from_ERA5"]
    same = sorted(map(os.path.basename, pooled)) == sorted(map(os.path.basename, single)) and all(
        filecmp.cmp(a, os.path.join(etl["paths"]["label_path"], os.path.basename(a)), shallow=False) for a in pooled)
    tree_root = os.path.dirname(paths["input_path"])
    for name in ("constant", "coord_1d.pickle", "coord_0p25d.pickle"):
        src = os.path.join(tree_root, name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, os.path.join(root, name))
    etl_paths = dict(paths, **etl["paths"], constant_path=os.path.join(root, "constant"),
                     in_coord_file=os.path.join(root, "coord_1d.pickle"),
                     out_coord_file=os.path.join(root, "coord_0p25d.pickle"))
    counts = {k: len(v) for k, v in etl["results"].items()}
    log(f"[etl] raw archives written in {raw_s:.1f} s: {len(grib_files)} GRIB2 files "
        f"({sum(os.path.getsize(f) for f in grib_files)} bytes) and {len(era5_files)} ERA5 NetCDF-3 files "
        f"({sum(os.path.getsize(f) for f in era5_files)} bytes); the tools in process, host clock s and outputs: "
        + ", ".join(f"{k} {etl['seconds'][k]:.2f} ({counts[k]})" for k in etl["seconds"])
        + f"; extract_variable_from_ERA5 again with --num_threads 2 (spawned workers) {pooled_s:.2f} s, its "
        f"{len(pooled)} files byte for byte those of the run without workers: {same}")
    with open(paths["input_map_file"], "rb") as a, open(etl_paths["input_map_file"], "rb") as b:
        want_keys, got_keys = sorted(pickle.load(a)), sorted(pickle.load(b))
    if got_keys != want_keys or counts["extract_variable_from_ERA5"] != 49 * 5 or counts["calc_mean_std"] != 11 \
            or not same:
        raise AssertionError(f"etl: index keys equal {got_keys == want_keys}, outputs {counts}, two workers' files "
                             f"the same: {same}")

    t0 = time.perf_counter()
    checked = etl_raster_errors(paths, etl_paths, grib_files, era5_files)
    worst = checked["worst"]
    log(f"[etl] every raster of the ETL-built tree against phase 19's ({checked['input_groups']} input times x 11 "
        f"variables, {checked['label_hours']} label hours x 6, {time.perf_counter() - t0:.1f} s): largest error, "
        "then at the largest share of its allowance: error / allowance (share): "
        + "; ".join(f"{k} {m:.3e}, {e:.3e} / {a:.3e} ({r:.3f})" for k, (m, e, a, r) in worst.items()))
    if len(worst) != 17 or any(r > 1.0 for *_, r in worst.values()):
        raise AssertionError(f"etl: rasters out of their codec's allowance: {worst}")

    # the command line on the ETL-built tree: train, infer two hours, test
    ckpt_dir, log_dir = os.path.join(tmp, "etl_ckpt"), os.path.join(tmp, "etl_log")
    shutil.copytree(seed_ckpt, ckpt_dir)
    tree = {k: etl_paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": etl_paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00"})
    sets = [f"train_cfg.{split}.{k}={v}" for split, seed in (("train_data", 0), ("valid_data", 1))
            for k, v in {**tree, "seed": seed}.items()]
    sets += ["train_cfg.log.with_vis=False", f"train_cfg.log.log_step={TRAINER_LOG_STEP}",
             f"train_cfg.tpu.pde_start_step={TRAINER_PDE_START}", f"inference_cfg.start_time={ETL_HOURS[0]}",
             f"inference_cfg.end_time={ETL_HOURS[1]}", "inference_cfg.log.with_vis=False",
             f"inference_cfg.log.vis_path={os.path.join(tmp, 'etl_out')}"]
    base = ["--config_file", FLAGSHIP_CFG, "--checkpoints_path", ckpt_dir]
    for item in sets:
        base += ["--set", item]
    reset_launch_counts()
    t0 = time.perf_counter()
    state = cli.main(base + ["--mode", "train", "--max_steps", str(ETL_STEPS), "--log_path", log_dir])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = launch_counts()
    losses = logged_losses(log_dir)
    want = v4s_launches_expected(1, ETL_STEPS)
    got = (train_counts["fused_decode_jvp_v4s"], train_counts["decode_bwd_kernel_v4s"])
    log(f"[etl] --mode train on the ETL-built tree from phase 19's seeded checkpoint: {state.step} steps in "
        f"{train_s:.1f} s, {len(losses)} logged losses, grad norms and validation losses, all finite: "
        f"{bool(losses) and all(np.isfinite(losses))}; v4s forward / backward launches {got[0]} / {got[1]} (phase 20's "
        f"count for steps 1-{ETL_STEPS}: {want[0]} / {want[1]})")
    if state.step != ETL_STEPS or not (losses and all(np.isfinite(losses))) or got != want:
        raise AssertionError(f"etl: training gave step {state.step}, losses {losses}, v4s launches {got} not {want}")

    reset_launch_counts()
    t0 = time.perf_counter()
    hours = cli.main(base + ["--mode", "inference"])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = launch_counts()["decode_primal_v4t"]
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = cli.main(base + ["--mode", "test"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = launch_counts()["decode_primal_v4t"]
    labelled = int(metrics["n_points"]) // GRID_POINTS
    rmse = {k[5:]: v for k, v in metrics.items() if k.startswith("rmse_")}
    log(f"[etl] --mode inference on {len(hours)} hours in {infer_s:.1f} s, {infer_launches} primal launches, grids "
        f"finite: {all(np.isfinite(g['T']).all() for _, g in hours)}; --mode test on the saved checkpoint (step "
        f"{metrics['global_step']:.0f}) in {test_s:.1f} s: {labelled} labelled hours, {test_launches} primal "
        "launches; RMSE " + ", ".join(f"{k} {v:.4g}" for k, v in rmse.items()))
    if len(hours) != 2 or infer_launches != 2 or not all(np.isfinite(g["T"]).all() for _, g in hours) \
            or test_launches != labelled or metrics["global_step"] != ETL_STEPS \
            or not (len(rmse) == 6 and all(np.isfinite(list(rmse.values())))):
        raise AssertionError(f"etl: inference {len(hours)} hours / {infer_launches} launches; test {metrics} with "
                             f"{test_launches} launches")

    # one loader item of the first window from each tree, alternating, and the tiles each decodes
    tc = cfg["train_cfg"]
    datasets = {}
    for name, p in (("etl", etl_paths), ("synthetic", paths)):
        data_cfg = dict(tc["train_data"], input_path=p["input_path"], label_path=p["label_path"],
                        constant_path=p["constant_path"], in_coord_file=p["in_coord_file"],
                        out_coord_file=p["out_coord_file"], input_data_map_cfg=dict(NCEP=p["input_map_file"]),
                        start_time="2008-01-01_00_00_00", end_time="2008-01-02_00_00_00", seed=0)
        datasets[name] = PhysicsDataset(**data_cfg, input_variable_cfg=cfg["variable_cfg"],
                                        out_variable_cfg=cfg["obs_norm_cfg"], dx=float(tc["dx"]), dy=float(tc["dy"]))
    decode = geotiff._segment_to_values
    tiles = {}
    for name, ds in datasets.items():
        n = [0]

        def counting(*a, **k):
            n[0] += 1
            return decode(*a, **k)

        geotiff._segment_to_values = counting
        try:
            ds[0]
        finally:
            geotiff._segment_to_values = decode
        tiles[name] = n[0]
    item_ms = {name: [] for name in datasets}
    for _ in range(ETL_LOADER_ITEMS):
        for name, ds in datasets.items():
            item_ms[name].append(host_ms(lambda: ds[0]))
    med = {k: statistics.median(v) for k, v in item_ms.items()}
    log(f"[etl] one loader item of the first window by host clock, ms (median of {ETL_LOADER_ITEMS}, alternating): "
        f"ETL-built tree (256 x 256 tiles) {med['etl']:.3f} {[round(t, 3) for t in item_ms['etl']]}, {tiles['etl']} "
        f"tiles decoded; phase 19's tree (16 x 16 tiles) {med['synthetic']:.3f} "
        f"{[round(t, 3) for t in item_ms['synthetic']]}, {tiles['synthetic']} tiles; ratio "
        f"{med['etl'] / med['synthetic']:.3f}")
    phase_s = time.perf_counter() - t_phase
    log(f"[etl] the phase took {phase_s:.1f} s by host clock")
    return dict(counts=train_counts, infer_launches=infer_launches, test_launches=test_launches,
                loader_ms=med, tiles=tiles, seconds=phase_s)


# phase 23: the encoder's model options (meta_cfg.attn_type='prob', meta_cfg.fused_qkv=True) at flagship width
OPTION_SETS = ("meta_cfg.attn_type=prob", "meta_cfg.fused_qkv=True")
OPTION_PDE_START = 1  # the PDE terms from the second step of each run from the seeded checkpoint
OPTION_HOST_STEPS = 2  # host-sampled from phase 19's seeded checkpoint
OPTION_DEVICE_STEPS, OPTION_RESUMED_STEPS = 2, 2  # sampled on the device, then resumed to step 4
OPTION_HOURS = ("2008-01-01_06_00_00", "2008-01-01_07_00_00")  # the inference run's two hours
# fused q/k/v against the three projections in float32 with TF32 off: JAX's own bar (test_models.py:119)
TOL_FUSED_QKV = 1e-5
PROB_TIMED_TOKENS = 4096  # ProbSparse attention alone beside the flash kernel
OPTION_TIMING_ROUNDS = 3  # encodes and PDE steps timed in turns, medians
# ResNet-50 on the card against the same module on the CPU, float32 (TF32 off), eval mode: each
# endpoint within TOL_RESNET of its largest value (cuDNN's and oneDNN's float32 sums in other orders)
RESNET_INPUT = (1, 145, 257, 64)
TOL_RESNET = 1e-4


def model_options_phase(dev, cd, cfg, window, dcfg, scfg, field, batch, paths, seed_ckpt: str, tmp: str,
                        launch_counts, reset_launch_counts) -> dict:
    """The encoder's model options at flagship width, bf16 (``--set meta_cfg.attn_type=prob --set
    meta_cfg.fused_qkv=True``, which every entry point reads through ``PhysicsNet``'s meta_cfg):
    (a) one encode of the seeded model: in each layer, on that layer's input, ProbSparse attention's
    u rows of each head against full attention with the same roundings (the attention checks' bf16
    bar) and against the plain path (``attention_xla``, a reading), every other row the value mean
    bit for bit, the key sample the numpy draw of JAX's ``randint`` and the same tensor on every
    call (C47), the selected queries against a float32 run on the same layer input (a query may
    change sides only where its float32 m lies within twice the head's largest bf16-float32
    difference of m of the cut: counted), fused q/k/v against the three projections in float32;
    (b) ``--mode train`` through the command line on phase 19's tree from its seeded checkpoint:
    ``OPTION_HOST_STEPS`` host-sampled steps, ``OPTION_DEVICE_STEPS`` sampled on the device, then
    that run resumed for ``OPTION_RESUMED_STEPS`` more (the PDE terms from each run's second step
    from the seeded checkpoint), with the v4s launches of
    ``v4s_launches_expected``, every logged loss finite, and the options' code run (ProbSparse
    attention and the fused product counted, once each a layer and encode); (c) ``--mode
    inference`` on ``OPTION_HOURS`` and ``--mode test`` with the checkpoints (b) wrote, one primal
    launch an hour; (d) ``fused_qkv=True`` with ``attn_impl='pallas'``: one encode and one PDE step
    (the single-tile kernel once a layer and forward, the v4s pair), each layer's tile kernel
    against its plain version on that layer's q, k, v, the tokens against the default model's
    (``encoder_close``) and the step's loss against the unfused 'pallas' model's; (e) readings by
    CUDA events and host clock: an encode at 287 tokens under full attention (plain, 'pallas',
    'flash') and ProbSparse, each with and without fused q/k/v; ProbSparse attention alone at
    ``PROB_TIMED_TOKENS`` tokens beside the flash kernel; a PDE step with both options against the
    default; (f) ResNet-50 at ``RESNET_INPUT`` (NHWC), eval mode, on the card against the same
    module on the CPU, float32.  Returns the launch counts and the readings."""
    import shutil

    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.models import backbone
    from deepphysinet_tpu_torch.models import transformer_net as tn
    from deepphysinet_tpu_torch.ops import attention as at
    from deepphysinet_tpu_torch.ops import prob_attention as pa
    from deepphysinet_tpu_torch.train import train_step as ts

    t_phase = time.perf_counter()
    meta_opts = dict(cfg["meta_cfg"], attn_type="prob", fused_qkv=True)
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    n_layers = int(cfg["meta_cfg"]["e_layers"])

    def fresh(meta, dtype=cd, impl=None):
        return ts.create_train_state(meta, cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                     torch.Generator().manual_seed(0), compute_dtype=dtype, device=dev,
                                     attn_impl=impl)

    def attention_layers(model):
        return [layer.attention for layer in model.meta_net.model.encoder.attn_layers]

    def encode_with_inputs(model):
        """One encode of the window and each attention layer's input in it."""
        xs = []
        hooks = [att.register_forward_pre_hook(lambda mod, a: xs.append(a[0].detach()))
                 for att in attention_layers(model)]
        try:
            tokens = runner._encode(model, field, fh_norm)
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        return tokens, xs

    def heads(att, x):
        b, length, d = x.shape
        return [t.reshape(b, length, att.n_heads, d // att.n_heads) for t in att.qkv(x)]

    # ---- (a) one encode at flagship width, bf16
    model = fresh(meta_opts).model.eval()
    model32 = fresh(meta_opts, torch.float32).model.eval()
    tokens, xs = encode_with_inputs(model)
    length = xs[0].shape[1]
    u, u_part = pa.top_counts(length, length)
    sample = pa.sample_indices(length, u_part, length, dev)
    draw_same = sample is pa.sample_indices(length, u_part, length, dev) and np.array_equal(
        sample.cpu().numpy(), pa.randint(pa.prng_key(0), (length, u_part), 0, length))
    readings, swapped, unexplained, fused_err = [], 0, [], 0.0
    with torch.no_grad():
        for i, (att, att32, x) in enumerate(zip(attention_layers(model), attention_layers(model32), xs)):
            q, k, v = heads(att, x)
            scale = q.shape[-1] ** -0.5
            got = pa.prob_attention(q, k, v, scale=scale).transpose(1, 2)  # [B, H, L, E]
            top = pa.top_queries(q, k)  # [B, H, u]
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            scores = pa._einsum_round(qh, kh.transpose(-1, -2), q.dtype) * torch.tensor(scale, dtype=q.dtype).item()
            full_same = pa._einsum_round(pa._softmax_like_jax(scores), vh, v.dtype)  # every row attended fully
            full_plain = at.attention_xla(q, k, v, scale).transpose(1, 2)
            selected = torch.zeros(got.shape[:3], dtype=torch.bool, device=dev).scatter_(2, top, True)
            sel = selected[..., None].expand_as(got)
            mean = pa._mean_round(vh, 2, keepdim=True).expand_as(got)
            rest_exact = bool((got[~sel] == mean[~sel]).all())
            err_same = float((got.float() - full_same.float())[sel].abs().max())
            err_plain = float((got.float() - full_plain.float())[sel].abs().max())
            step = bf16_step(full_same.float())
            # how many rows left at the value mean also lie within the bar of full attention
            near = int(((mean.float() - full_same.float()).abs().amax(-1) <= step)[~selected].sum())
            q32, k32, v32 = heads(att32, x.float())
            top32 = pa.top_queries(q32, k32)
            m16, m32 = pa.sparsity_measure(q, k).float(), pa.sparsity_measure(q32, k32)
            for h in range(q.shape[2]):
                a, b = set(top[0, h].tolist()), set(top32[0, h].tolist())
                cut = float(torch.sort(m32[0, h], descending=True).values[u - 1])
                delta = 2.0 * float((m16[0, h] - m32[0, h]).abs().max())
                swapped += len(a - b)
                unexplained += [(i, h, l) for l in a ^ b if abs(float(m32[0, h, l]) - cut) > delta]
            fused = att32.qkv(x.float())
            att32.fused_qkv = False
            try:
                three = att32.qkv(x.float())
            finally:
                att32.fused_qkv = True
            fused_err = max(fused_err, max(float((a_ - b_).abs().max()) for a_, b_ in zip(fused, three)))
            readings.append(dict(err_same=err_same, err_plain=err_plain, step=step, rest_exact=rest_exact, near=near))
            log(f"[options] layer {i}: ProbSparse attention, {u} of {length} rows of each of {q.shape[2]} heads attended "
                f"fully; those rows against full attention with the same roundings max {err_same:.3e} (bound one bf16 "
                f"step of the largest, {step:.3e}), against the plain path (attention_xla) {err_plain:.3e} (a reading); "
                f"the other rows the value mean bit for bit: {rest_exact} ({near} of them also within the bound of "
                f"their full-attention row)")
    log(f"[options] the key sample [{length}, {u_part}] on the card is the numpy draw of JAX's randint(PRNGKey(0)) and "
        f"the same tensor on a second call: {draw_same}; selected queries, bf16 against float32 on each layer's "
        f"input: {swapped} of {n_layers * q.shape[2] * u} changed sides, {len(unexplained)} of them outside twice the "
        f"head's bf16-float32 spread of m about the cut {unexplained[:4]}; fused q/k/v against the three projections "
        f"(float32, TF32 off) max {fused_err:.3e} (bound {TOL_FUSED_QKV:.0e}); tokens {tuple(tokens.shape)} finite "
        f"{bool(torch.isfinite(tokens).all())}")
    if not (draw_same and not unexplained and fused_err <= TOL_FUSED_QKV and bool(torch.isfinite(tokens).all())
            and all(r["rest_exact"] and r["err_same"] <= r["step"] for r in readings)):
        raise AssertionError(f"options: one encode failed its checks: {readings}, draw {draw_same}, unexplained "
                             f"{unexplained}, fused {fused_err}")
    del model, model32, xs

    # ---- (b) --mode train and (c) --mode inference / --mode test through the command line
    dirs = {k: os.path.join(tmp, f"options_ckpt_{k}") for k in ("host", "device")}
    log_dir = os.path.join(tmp, "options_log")
    for d in dirs.values():
        shutil.copytree(seed_ckpt, d)
    tree = {k: paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00"})
    sets = [f"train_cfg.{split}.{k}={v}" for split, seed in (("train_data", 0), ("valid_data", 1))
            for k, v in {**tree, "seed": seed}.items()]
    sets += ["train_cfg.log.with_vis=False", f"train_cfg.log.log_step={TRAINER_LOG_STEP}",
             f"train_cfg.tpu.pde_start_step={OPTION_PDE_START}", f"inference_cfg.start_time={OPTION_HOURS[0]}",
             f"inference_cfg.end_time={OPTION_HOURS[1]}", "inference_cfg.log.with_vis=False",
             f"inference_cfg.log.vis_path={os.path.join(tmp, 'options_out')}", *OPTION_SETS]
    device_sets = ["train_cfg.tpu.sample_mode=device", "train_cfg.train_data.in_memory=True",
                   "train_cfg.valid_data.in_memory=True"]

    def args(run, *extra):
        out = ["--config_file", FLAGSHIP_CFG, "--checkpoints_path", dirs[run], *extra]
        for item in sets + (device_sets if run == "device" else []):
            out += ["--set", item]
        return out

    calls = {"prob": 0, "fused": 0}
    prob_fn, qkv_fn = tn.prob_attention, tn.AttentionLayer.qkv

    def counting_prob(*a, **k):
        calls["prob"] += 1
        return prob_fn(*a, **k)

    def counting_qkv(self, x):
        calls["fused"] += int(self.fused_qkv)
        return qkv_fn(self, x)

    tn.prob_attention, tn.AttentionLayer.qkv = counting_prob, counting_qkv
    seconds, runs_calls = {}, {}
    try:
        reset_launch_counts()
        for name, run, steps in (("host", "host", OPTION_HOST_STEPS), ("device", "device", OPTION_DEVICE_STEPS),
                                 ("resumed", "device", OPTION_DEVICE_STEPS + OPTION_RESUMED_STEPS)):
            t0 = time.perf_counter()
            state = cli.main(args(run, "--mode", "train", "--max_steps", str(steps), "--log_path", log_dir))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            runs_calls[name] = dict(calls, step=state.step)
        train_counts = launch_counts()
        reset_launch_counts()
        t0 = time.perf_counter()
        hours = cli.main(args("host", "--mode", "inference"))
        torch.cuda.synchronize()
        seconds["inference"] = time.perf_counter() - t0
        infer_launches = launch_counts()["decode_primal_v4t"]
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = cli.main(args("device", "--mode", "test"))
        torch.cuda.synchronize()
        seconds["test"] = time.perf_counter() - t0
        test_launches = launch_counts()["decode_primal_v4t"]
    finally:
        tn.prob_attention, tn.AttentionLayer.qkv = prob_fn, qkv_fn
    losses = logged_losses(log_dir)
    want = [sum(x) for x in zip(v4s_launches_expected(1, OPTION_HOST_STEPS, OPTION_PDE_START),
                                v4s_launches_expected(1, OPTION_DEVICE_STEPS, OPTION_PDE_START),
                                v4s_launches_expected(OPTION_DEVICE_STEPS + 1,
                                                      OPTION_DEVICE_STEPS + OPTION_RESUMED_STEPS, OPTION_PDE_START))]
    got = [train_counts["fused_decode_jvp_v4s"], train_counts["decode_bwd_kernel_v4s"]]
    steps = [runs_calls[k]["step"] for k in ("host", "device", "resumed")]
    labelled = int(metrics["n_points"]) // GRID_POINTS
    rmse = {k[5:]: v for k, v in metrics.items() if k.startswith("rmse_")}
    log(f"[options] --mode train with {' '.join('--set ' + s_ for s_ in OPTION_SETS)}: {steps[0]} host-sampled steps in "
        f"{seconds['host']:.1f} s, {steps[1]} sampled on the device in {seconds['device']:.1f} s, resumed to step "
        f"{steps[2]} in {seconds['resumed']:.1f} s; {len(losses)} logged losses, grad norms and validation losses, all "
        f"finite: {bool(losses) and all(np.isfinite(losses))}; v4s forward / backward launches {got[0]} / {got[1]} "
        f"(expected {want[0]} / {want[1]}); ProbSparse attention and fused q/k/v calls after each run "
        f"{[(runs_calls[k]['prob'], runs_calls[k]['fused']) for k in ('host', 'device', 'resumed')]}")
    log(f"[options] --mode inference on {len(hours)} hours with the host run's checkpoint in {seconds['inference']:.1f} s, "
        f"{infer_launches} primal launches, grids finite: {all(np.isfinite(g['T']).all() for _, g in hours)}; --mode "
        f"test with the resumed run's (step {metrics['global_step']:.0f}) in {seconds['test']:.1f} s: {labelled} "
        f"labelled hours, {test_launches} primal launches; RMSE " + ", ".join(f"{k} {v:.4g}" for k, v in rmse.items())
        + f"; ProbSparse attention and fused q/k/v calls in all {calls}")
    options_used = calls["prob"] == calls["fused"] and calls["prob"] % n_layers == 0 and all(
        runs_calls[a]["prob"] > (runs_calls[b]["prob"] if b else 0)
        for a, b in (("host", None), ("device", "host"), ("resumed", "device")))
    if not (losses and all(np.isfinite(losses))) or got != want or steps != [OPTION_HOST_STEPS, OPTION_DEVICE_STEPS,
                                                                            OPTION_DEVICE_STEPS + OPTION_RESUMED_STEPS] \
            or not options_used or calls["prob"] <= runs_calls["resumed"]["prob"]:
        raise AssertionError(f"options: training gave steps {steps}, losses {losses}, v4s launches {got} not {want}, "
                             f"option calls {runs_calls} / {calls}")
    if len(hours) != 2 or infer_launches != 2 or not all(np.isfinite(g["T"]).all() for _, g in hours) \
            or test_launches != labelled or metrics["global_step"] != steps[2] \
            or not (len(rmse) == 6 and all(np.isfinite(list(rmse.values())))):
        raise AssertionError(f"options: inference {len(hours)} hours / {infer_launches} launches; test {metrics} with "
                             f"{test_launches} launches")

    # ---- (d) fused q/k/v with attn_impl='pallas': one encode and one PDE step
    meta_fused = dict(cfg["meta_cfg"], fused_qkv=True)
    state_p = fresh(meta_fused, impl="pallas")
    state_p.model.eval()
    reset_launch_counts()
    tokens_p, xs_p = encode_with_inputs(state_p.model)
    with torch.no_grad():  # each layer's q, k, v before the step moves the weights
        qkvs = [heads(att, x) for att, x in zip(attention_layers(state_p.model), xs_p)]
    state_p.model.train()
    state_p, step_metrics = ts.make_train_step(scfg)(state_p, batch, True)
    torch.cuda.synchronize()
    d_counts = {k: v for k, v in launch_counts().items() if v}
    d_want = {"attention_tile": 2 * n_layers, "fused_decode_jvp_v4s": 2, "decode_bwd_kernel_v4s": 2}
    tile_errs = []
    for q, k, v in qkvs:
        scale = q.shape[-1] ** -0.5
        got_t = at.attention_tile(q, k, v, scale)
        torch.cuda.synchronize()
        want_t = at.attention_tile_ref(q, k, v, scale)
        tile_errs.append((float((got_t.float() - want_t.float()).abs().max()), bf16_step(want_t.float())))
    with torch.no_grad():
        base_tokens = runner._encode(fresh(cfg["meta_cfg"]).model.eval(), field, fh_norm)
    t_err, t_mean, t_ok = encoder_close(tokens_p, base_tokens, cd)
    unfused = fresh(cfg["meta_cfg"], impl="pallas").model
    unfused_loss = float(ts.make_loss_fn(unfused, scfg)(batch, True)[0].detach())
    del unfused
    loss = float(step_metrics["total_loss"])
    loss_rel = abs(loss - unfused_loss) / abs(unfused_loss)
    log(f"[options] fused_qkv=True, attn_impl='pallas': kernel launches in one encode and one PDE step {d_counts} "
        f"(expected {d_want}); each layer's single-tile kernel against its plain version on that layer's q, k, v: "
        + ", ".join(f"{e:.3e} (bound {b:.3e})" for e, b in tile_errs)
        + f"; tokens against the default model's at most {t_err:.3e} (mean {t_mean:.3f} bf16 steps of the largest; "
        f"bounds as the encoder kernel's); the step's total loss {loss:.8g} against the unfused 'pallas' model's "
        f"{unfused_loss:.8g} (relative {loss_rel:.1e}, bound {RTOL_VERSIONS_LOSS[cd]:.0e})")
    if d_counts != d_want or not all(e <= b for e, b in tile_errs) or not t_ok \
            or not np.isfinite(loss) or loss_rel > RTOL_VERSIONS_LOSS[cd] or float(step_metrics["skipped_nonfinite"]):
        raise AssertionError(f"options: fused q/k/v under attn_impl='pallas' failed: launches {d_counts}, tile "
                             f"{tile_errs}, tokens {t_err}, loss {loss} / {unfused_loss}")
    del state_p, qkvs, xs_p

    # ---- (e) readings: encodes, ProbSparse attention alone, PDE steps
    enc_model = fresh(cfg["meta_cfg"]).model.eval()
    variants = [(attn_type, impl, fused) for attn_type, impl in (("full", "xla"), ("full", "pallas"),
                                                                 ("full", "flash"), ("prob", None))
                for fused in (False, True)]

    def encode_as(attn_type, impl, fused):
        for att in attention_layers(enc_model):
            att.attn_type, att.attn_impl, att.fused_qkv = attn_type, impl, fused
        return lambda: runner._encode(enc_model, field, fh_norm)

    enc_times = {v_: {"device": [], "host": []} for v_ in variants}
    for v_ in variants:
        encode_as(*v_)()
    for _ in range(OPTION_TIMING_ROUNDS):
        for v_ in variants:
            fn = encode_as(*v_)
            enc_times[v_]["device"].append(cuda_ms(fn, 20))
            enc_times[v_]["host"].append(host_ms(fn))
    enc_ms = {v_: {k: statistics.median(t_) for k, t_ in d_.items()} for v_, d_ in enc_times.items()}
    del enc_model
    log("[options] one encode at 287 tokens, ms (medians of " + str(OPTION_TIMING_ROUNDS) + " in turns; CUDA events "
        "over 20 calls / host clock around one call): " + "; ".join(
            f"{a}{'' if a == 'prob' else ' ' + i}{' fused' if f else ''} {enc_ms[(a, i, f)]['device']:.3f} / "
            f"{enc_ms[(a, i, f)]['host']:.3f}" for a, i, f in variants))
    g = torch.Generator().manual_seed(17)
    qkv_long = [torch.randn(1, PROB_TIMED_TOKENS, ATTN_HEADS, ATTN_HEAD_DIM, generator=g).to(dev, cd) for _ in range(3)]
    scale = ATTN_HEAD_DIM ** -0.5
    t0 = time.perf_counter()
    pa.prob_attention(*qkv_long, scale=scale)  # the first call at this length: the key sample drawn and copied
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    prob_long = lambda: pa.prob_attention(*qkv_long, scale=scale)  # noqa: E731
    flash_long = lambda: at.attention_flash(*qkv_long, scale)  # noqa: E731
    long_ms = {"prob": cuda_ms(prob_long, 20), "flash": cuda_ms(flash_long, 20),
               "prob_device": device_ms(prob_long, 20), "flash_device": device_ms(flash_long, 20)}
    u_long, _ = pa.top_counts(PROB_TIMED_TOKENS, PROB_TIMED_TOKENS)
    log(f"[options] at {PROB_TIMED_TOKENS} tokens ({ATTN_HEADS} heads of {ATTN_HEAD_DIM}, bf16): ProbSparse attention "
        f"({u_long} rows a head attend fully) {long_ms['prob']:.4f} ms a call, {long_ms['prob_device']:.4f} ms on the "
        f"device alone (first call {first_ms:.1f} ms, the key sample drawn on the host); the flash kernel "
        f"{long_ms['flash']:.4f} / {long_ms['flash_device']:.4f} ms")
    del qkv_long
    step = ts.make_train_step(scfg)
    states = {"default": fresh(cfg["meta_cfg"]), "options": fresh(meta_opts)}
    step_times = {k: [] for k in states}
    def one_step(name):
        states[name] = step(states[name], batch, True)[0]

    for name in states:
        one_step(name)
    for _ in range(OPTION_TIMING_ROUNDS):
        for name in ("default", "options", "options", "default"):
            step_times[name].append(host_ms(lambda: one_step(name)))
    step_ms = {k: statistics.median(v_) for k, v_ in step_times.items()}
    del states
    log(f"[options] one PDE step by host clock, ms (median of {2 * OPTION_TIMING_ROUNDS}, in turns): default "
        f"{step_ms['default']:.3f}, with ProbSparse attention and fused q/k/v {step_ms['options']:.3f} "
        f"({[round(t_, 3) for t_ in step_times['default']]} / {[round(t_, 3) for t_ in step_times['options']]})")

    # ---- (f) ResNet-50 on the card against the CPU, float32
    keys = ("C1", "C2", "C3", "C4", "C5")
    torch.manual_seed(0)
    net = backbone.build_backbone("resnet50", out_keys=keys, in_channels=RESNET_INPUT[-1])
    gen = torch.Generator().manual_seed(5)
    for name, buf in net.named_buffers():  # running statistics away from their (0, 1) start
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        elif name.endswith("running_var"):
            buf.copy_(1.0 + 0.1 * torch.rand(buf.shape, generator=gen))
    x = torch.randn(*RESNET_INPUT, generator=gen)
    t0 = time.perf_counter()
    with torch.no_grad():
        want_r = net(x)
    cpu_s = time.perf_counter() - t0
    net = net.to(dev)
    xd = x.to(dev)
    with torch.no_grad():
        got_r = net(xd)
        torch.cuda.synchronize()
        resnet_ms = cuda_ms(lambda: net(xd), 10)
    r_errs = {k: float((got_r[k].cpu() - want_r[k]).abs().max()) / float(want_r[k].abs().max()) for k in keys}
    log(f"[options] ResNet-50, input {RESNET_INPUT} NHWC, eval mode, float32: endpoints "
        + ", ".join(f"{k} {tuple(got_r[k].shape)}" for k in keys) + "; on the card against the CPU, max error over "
        "the endpoint's largest: " + ", ".join(f"{k} {e:.2e}" for k, e in r_errs.items())
        + f" (bound {TOL_RESNET:.0e}); {resnet_ms:.3f} ms a forward on the card (CUDA events), {cpu_s:.2f} s on the CPU")
    if any(e > TOL_RESNET for e in r_errs.values()) or any(tuple(got_r[k].shape) != tuple(want_r[k].shape)
                                                          for k in keys):
        raise AssertionError(f"options: ResNet-50 on the card disagrees with the CPU: {r_errs}")
    del net, xd, got_r
    phase_s = time.perf_counter() - t_phase
    log(f"[options] the phase took {phase_s:.1f} s by host clock")
    return dict(launches={"decode_primal_v4t": infer_launches + test_launches,
                          "fused_decode_jvp_v4s": got[0] + d_counts["fused_decode_jvp_v4s"],
                          "decode_bwd_kernel_v4s": got[1] + d_counts["decode_bwd_kernel_v4s"],
                          "attention_tile": d_counts["attention_tile"]},
                encode_ms=enc_ms, long_ms=long_ms, step_ms=step_ms, resnet_ms=resnet_ms, seconds=phase_s)


# phase 24: data-parallel training (ROADMAP A7): NCCL at world size 1 under torchrun, two gloo ranks
# sharing the card against one process, checkpoints across topologies
DIST_HOST_STEPS, DIST_DEVICE_STEPS, DIST_PDE_START = 3, 2, 1
DIST_CHILD_TIMEOUT = 240  # seconds: the torchrun child's runs take about a minute
# (b)'s bars: float32 (TF32 off) losses as phase 9's step (RTOL_STEP); the parameters after one Adam
# step by the CPU tests' rule (no entry further apart than 2 lr, all but a share of the entries within
# lr 2e-2); bf16 within C5's spread: a bf16 gradient's entries move by 7e-3 of its largest between two
# runs of one engine, so an entry whose gradient lies within that noise of zero steps either way: the
# losses at RTOL_STEP's bf16 bar, the parameters within 2 lr with all but one entry in 100 within lr 2e-2
DIST_PARAM_SHARE = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def dist_child(argv) -> int:
    """One rank of phase 24 (a), started by ``torch.distributed.run``: the command line's ``--dist``
    train mode in process (it joins the NCCL group of torchrun's environment and leaves it at its
    end) with the arguments ``argv[1]`` (JSON); writes the launches of the run, the lead times its loss
    snapped and the backend of each averaging to ``argv[0]`` (JSON)."""
    import faulthandler

    faulthandler.dump_traceback_later(DIST_CHILD_TIMEOUT - 30, exit=True)  # a hang shows where, then ends
    out_path, args = argv[0], json.loads(argv[1])
    from deepphysinet_tpu_torch import cli
    from deepphysinet_tpu_torch.parallel import dryrun
    from deepphysinet_tpu_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    snapped, snap = [], ts._snap_forecast_h

    def recording_snap(fh, cfg):
        out = snap(fh, cfg)
        snapped.append(dict(snap=cfg.forecast_h_snap, lead=fh.tolist(), snapped=out.tolist()))
        return out

    ts._snap_forecast_h = recording_snap
    from deepphysinet_tpu_torch.parallel import sharding

    reduced, mean = [], sharding.mean_over_ranks_

    def recording_mean(tensors):  # the backend each averaging runs through
        reduced.append(torch.distributed.get_backend() if torch.distributed.is_initialized() else None)
        return mean(tensors)

    sharding.mean_over_ranks_ = recording_mean
    before = dryrun.launch_counts()
    t0 = time.perf_counter()
    state = cli.main(args + ["--dist"])
    torch.cuda.synchronize()
    result = dict(world=int(os.environ.get("WORLD_SIZE", "0")), seconds=time.perf_counter() - t0, step=state.step,
                  device=str(next(state.model.parameters()).device), snaps=snapped, reductions=reduced,
                  launches={k: v - before[k] for k, v in dryrun.launch_counts().items() if v != before[k]})
    with open(out_path, "w") as fp:
        json.dump(result, fp)
    return 0


def dist_nccl_part(cfg, paths, seed_ckpt: str, tmp: str) -> dict:
    """Phase 24 (a): the torchrun child over NCCL; returns its v4s launches by run."""
    import shutil

    from deepphysinet_tpu_torch.parallel import dryrun

    # ---- (a) NCCL at world size 1 under torchrun --------------------------------------------------
    tree = {k: paths[k] for k in ("input_path", "label_path", "constant_path", "in_coord_file", "out_coord_file")}
    tree.update({"input_data_map_cfg.NCEP": paths["input_map_file"], "start_time": "2008-01-01_00_00_00",
                 "end_time": "2008-01-02_00_00_00"})
    sets = [f"train_cfg.{split}.{k}={v}" for split, seed in (("train_data", 0), ("valid_data", 1))
            for k, v in {**tree, "seed": seed}.items()]
    sets += ["train_cfg.log.with_vis=False", f"train_cfg.log.log_step={TRAINER_LOG_STEP}",
             f"train_cfg.tpu.pde_start_step={DIST_PDE_START}"]
    runs = {}
    for name, steps, extra in (("host", DIST_HOST_STEPS, []),
                               ("device", DIST_DEVICE_STEPS, ["train_cfg.tpu.sample_mode=device",
                                                              "train_cfg.train_data.in_memory=True",
                                                              "train_cfg.valid_data.in_memory=True"])):
        ckpt_dir = os.path.join(tmp, f"dist_ckpt_{name}")
        shutil.copytree(seed_ckpt, ckpt_dir)
        args = ["--config_file", FLAGSHIP_CFG, "--checkpoints_path", ckpt_dir, "--mode", "train", "--max_steps",
                str(steps), "--log_path", os.path.join(tmp, f"dist_log_{name}")]
        for item in (*sets, *extra):
            args += ["--set", item]
        runs[name] = args
    child, child_s = {}, 0.0
    for name, args in runs.items():  # one torchrun child a run: each CLI joins and leaves its own group
        out_json, child_log = os.path.join(tmp, f"dist_child_{name}.json"), os.path.join(tmp, f"dist_child_{name}.log")
        t0 = time.perf_counter()
        with open(child_log, "w") as fp:
            proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                                   "--master_addr", "localhost", "--master_port", str(dryrun.free_port()),
                                   os.path.abspath(__file__), "--dist_child", out_json, json.dumps(args)],
                                  stdout=fp, stderr=subprocess.STDOUT, timeout=DIST_CHILD_TIMEOUT + 60)
        child_s += time.perf_counter() - t0
        if proc.returncode != 0:
            print(open(child_log).read()[-6000:], file=sys.stderr)
            raise AssertionError(f"dist (a): the torchrun child of the {name}-sampled run failed "
                                 f"(exit code {proc.returncode})")
        child[name] = json.load(open(out_json))
        child["world"] = child[name]["world"]
    losses = {n: logged_losses(os.path.join(tmp, f"dist_log_{n}")) for n in runs}
    want = {"host": v4s_launches_expected(1, DIST_HOST_STEPS, DIST_PDE_START),
            "device": v4s_launches_expected(1, DIST_DEVICE_STEPS, DIST_PDE_START)}
    got = {n: (child[n]["launches"].get("fused_decode_jvp_v4s", 0), child[n]["launches"].get("decode_bwd_kernel_v4s", 0))
           for n in runs}
    host_snaps = child["host"]["snaps"]
    leads = sorted({x for s in host_snaps for x in s["lead"]})
    snapped_ok = bool(host_snaps) and all(s["snap"] == 24.0 and s["snapped"] == [np.floor(x / 24.0) * 24.0 for x in
                                                                                  s["lead"]] for s in host_snaps)
    unsnapped_ok = all(s["snap"] == 0.0 and s["snapped"] == s["lead"] for s in child["device"]["snaps"])
    nccl = {n: (len(child[n]["reductions"]), sorted(set(map(str, child[n]["reductions"])))) for n in runs}
    nccl_ok = all(k > 0 and b == ["nccl"] for k, b in nccl.values())
    log(f"[dist] (a) torchrun --nproc_per_node 1, cli --dist over NCCL (world size {child['world']}) in "
        f"{child_s:.1f} s: host-sampled {child['host']['step']} steps in {child['host']['seconds']:.1f} s, "
        f"device-sampled {child['device']['step']} in {child['device']['seconds']:.1f} s, on {child['host']['device']}; "
        f"v4s forward / backward launches {got['host']} and {got['device']} (expected {want['host']} and "
        f"{want['device']}); {sum(map(len, losses.values()))} logged losses, all finite: "
        f"{all(np.isfinite(x).all() for x in losses.values())}; host-sampled lead times {leads} h snapped to the "
        f"24-hour window {snapped_ok} ({len(host_snaps)} losses), the device-sampled loss's left as they are "
        f"{unsnapped_ok}; averagings through the group (gradients and metrics, each step and validation) "
        f"{nccl}")
    if not nccl_ok or got != want or not snapped_ok or not unsnapped_ok or not all(losses.values()) or not all(
            np.isfinite(x).all() for x in losses.values()) or child["host"]["step"] != DIST_HOST_STEPS:
        raise AssertionError(f"dist (a): launches {got} (expected {want}), snapped {snapped_ok} / {unsnapped_ok}, "
                             f"losses {losses}")

    return got


def dist_gloo_part(dev, cd, cfg, seed_ckpt: str, tmp: str):
    """Phase 24 (b) and (c): two gloo ranks on the card against one process, checkpoints across
    topologies; returns each case's v4s launches in each rank and the readings."""
    from deepphysinet_tpu_torch.data.window import synthetic_batch
    from deepphysinet_tpu_torch.parallel import dryrun
    from deepphysinet_tpu_torch.train import checkpoint as ckpt
    from deepphysinet_tpu_torch.train import train_step as ts

    # ---- (b), (c) two gloo ranks on the card against one process; checkpoints across topologies ----
    meta, net, opt = cfg["meta_cfg"], cfg["net_cfg"], dict(cfg["train_cfg"]["optimizer"])
    parts = [synthetic_batch(cfg, seed=s) for s in (0, 1)]
    glob_batch = {"field": np.concatenate([p["field"] for p in parts]),
                  "forecast_h": np.concatenate([np.asarray(p["forecast_h"]).reshape(-1) for p in parts])}
    for key in ("margin", "inter"):
        glob_batch[key] = {k: np.concatenate([p[key][k] for p in parts]) for k in parts[0][key]}
    scfg = ts.step_config_from_cfg(cfg)
    one_ckpt, rank_ckpt = os.path.join(tmp, "dist_one_process"), os.path.join(tmp, "dist_rank0")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def start_state(dtype):
        state = ts.create_train_state(meta, net, opt, torch.Generator().manual_seed(0), compute_dtype=dtype, device=dev)
        payload, _, step = ckpt.load_checkpoint(one_ckpt, prefix="physics")
        ckpt.restore_train_state(state, payload, False)
        state.step = step
        return state

    # the one-process checkpoint: phase 19's seeded weights after one PDE step on window 0 (Adam moments on)
    state = ts.create_train_state(meta, net, opt, torch.Generator().manual_seed(0), compute_dtype=cd, device=dev)
    payload, _, _ = ckpt.load_checkpoint(seed_ckpt, prefix="physics")
    state.model.load_state_dict(payload["model"])
    state, _ = ts.make_train_step(scfg)(state, ts.batch_to_device(parts[0], device=dev), True)
    ckpt.save_checkpoint(one_ckpt, 0, state.step, state.model, state.optimizer, prefix="physics")
    del state
    cases = [dict(name=str(dt).split(".")[-1], kind="host", mesh=(2, 1), batch=glob_batch, cfg=scfg, with_pde=True,
                  compute_dtype=str(dt).split(".")[-1]) for dt in (torch.float32, torch.bfloat16)]
    spec_path = os.path.join(tmp, "dist_spec.pt")
    torch.save(dict(meta=meta, net=net, opt=opt, checkpoint=one_ckpt, save_dir=rank_ckpt, tf32=False, cases=cases,
                    time_reduce=3), spec_path)
    t0 = time.perf_counter()
    dryrun.launch(2, ["--child", spec_path, os.path.join(tmp, "dist_out"), "--backend", "gloo"], timeout=600)
    ranks_s = time.perf_counter() - t0
    ranks = dryrun.read_results(os.path.join(tmp, "dist_out"), 2)
    rank_launches = []
    readings = {}
    def one_process(dtype, micro: bool):
        """This process's step over both windows from the one-process checkpoint: the batch of two
        windows (``micro=False``), or the two windows as two micro-batches of one, each encoded alone as a
        rank encodes its window, their gradients summed before the one clip and Adam update."""
        state = start_state(dtype)
        t0 = time.perf_counter()
        if not micro:
            state, m = ts.make_train_step(scfg)(state, ts.batch_to_device(glob_batch, device=dev), True)
        else:
            state.optimizer.zero_grad(set_to_none=True)
            per, var = [], []
            for part in parts:
                batch = ts.batch_to_device(part, device=dev)
                total, (m, pred) = ts.make_loss_fn(state.model, scfg)(batch, True)
                (total / len(parts)).backward()
                per.append({k: v.detach() for k, v in m.items()})
                with torch.no_grad():
                    var.append(ts._variable_metrics(pred, batch.margin.labels, scfg))

            def mean(dicts):
                return {k: torch.stack([d[k] for d in dicts]).mean() for k in dicts[0]}

            m = ts.apply_gradient_update(scfg, state, mean(per))
            m.update(mean(var))
        torch.cuda.synchronize()
        return state, {k: float(v) for k, v in m.items()}, time.perf_counter() - t0

    def against(r0, state, m_ref, dtype):
        loss_rel = {k: abs(r0["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in m_ref.items()}
        key = max(loss_rel, key=loss_rel.get)
        lr = max(g["lr"] for g in state.optimizer.param_groups)
        reach, atol = 2 * lr * 1.01, lr * 2e-2
        off = total = 0
        worst = 0.0
        for k, v in state.model.state_dict().items():
            diff = (r0["params"][k] - v.detach().float().cpu()).abs()
            worst = max(worst, float(diff.max()))
            if not k.endswith("key_projection.bias"):
                off += int((diff > atol).sum())
                total += diff.numel()
        params_ok = worst <= reach and off <= DIST_PARAM_SHARE[dtype] * total
        return dict(loss_rel=loss_rel[key], key=key, total_rel=loss_rel["total_loss"], worst=worst, reach=reach,
                    atol=atol, off=off, total=total, ok=loss_rel[key] <= RTOL_STEP[dtype][0] and params_ok,
                    batch_ok=loss_rel["total_loss"] <= RTOL_VERSIONS_LOSS[dtype] and params_ok)

    for case in cases:
        dtype = getattr(torch, case["compute_dtype"])
        r0, r1 = (r["results"][case["name"]] for r in ranks)
        same = r0["metrics"] == r1["metrics"]
        launches = [(r["results"][case["name"]]["launches"].get("fused_decode_jvp_v4s", 0),
                     r["results"][case["name"]]["launches"].get("decode_bwd_kernel_v4s", 0)) for r in ranks]
        rank_launches.append(launches)
        cmp = {}
        for micro in (True, False):
            state, m_ref, secs = one_process(dtype, micro)
            cmp[micro] = dict(against(r0, state, m_ref, dtype), total_loss=m_ref["total_loss"], seconds=secs)
            del state
        readings[case["name"]] = dict(micro=cmp[True], batched=cmp[False], rank_s=r0["seconds"])
        x = cmp[True]
        log(f"[dist] (b) two gloo ranks on {ranks[0]['device']} / {ranks[1]['device']}, one PDE step each on its "
            f"window, {case['name']}, against one process over both windows as two micro-batches of one window (each "
            f"encoded alone, as a rank encodes its own): total loss {r0['metrics']['total_loss']:.8g} / "
            f"{x['total_loss']:.8g}, every metric within {x['loss_rel']:.2e} ({x['key']}; bound "
            f"{RTOL_STEP[dtype][0]:.0e}); parameters at most {x['worst']:.3g} apart (bound {x['reach']:.3g}), {x['off']} "
            f"of {x['total']} entries past {x['atol']:.2g} (bound {DIST_PARAM_SHARE[dtype]:.0e} of them); the step "
            f"{x['seconds'] * 1e3:.1f} ms in one process, {r0['seconds'] * 1e3:.1f} ms in a rank (its first)")
        x = cmp[False]
        log(f"[dist] (b) {case['name']}, against one process over both windows as one batch of two windows (the "
            f"encoder sums a batch of two in another order, C17): total loss {x['total_loss']:.8g}, relative "
            f"{x['total_rel']:.2e} (bound {RTOL_VERSIONS_LOSS[dtype]:.0e}), the largest metric's {x['loss_rel']:.2e} "
            f"({x['key']}); parameters at most {x['worst']:.3g} apart, {x['off']} of {x['total']} entries past "
            f"{x['atol']:.2g} (bound {DIST_PARAM_SHARE[dtype]:.0e} of them); "
            + ("held" if dtype == torch.float32 else "not held in bf16, where the step amplifies a change of the "
               "encoder's rounding (C17)"))
        log(f"[dist] (b) {case['name']}: the ranks' metrics equal: {same}; v4s launches a rank {launches}")
        held = cmp[True]["ok"] and (dtype == torch.bfloat16 or cmp[False]["batch_ok"])
        if not (same and held and launches == [(2, 2), (2, 2)] and all(np.isfinite(list(r0["metrics"].values())))):
            raise AssertionError(f"dist (b): two ranks against one process, {case['name']}")
    if ranks[0].get("reduce_ms"):
        log(f"[dist] (b) gloo all-reduce of the flat gradient buffer ({ranks[0]['reduce_bytes'] / 1e6:.1f} MB, "
            f"CUDA tensors through the host) on two ranks sharing the card: {ranks[0]['reduce_ms']} ms; the ranks ran "
            f"in {ranks_s:.1f} s with their start")
    # (c): rank 0's checkpoint of the bf16 step resumes in one process
    resumed = ts.create_train_state(meta, net, opt, torch.Generator().manual_seed(0), compute_dtype=cd, device=dev)
    payload, epoch, step = ckpt.load_checkpoint(rank_ckpt, prefix="physics")
    ckpt.restore_train_state(resumed, payload, False)
    r0 = ranks[0]["results"][cases[-1]["name"]]
    same_params = all(torch.equal(v.detach().float().cpu(), r0["params"][k])
                      for k, v in resumed.model.state_dict().items())
    adam = sorted({int(v["step"]) for v in resumed.optimizer.state_dict()["state"].values()})
    same_moments = all(torch.equal(a["exp_avg"].cpu(), b["exp_avg"].cpu()) and
                       torch.equal(a["exp_avg_sq"].cpu(), b["exp_avg_sq"].cpu())
                       for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                                       r0["optim_state"]["state"].values()))
    log(f"[dist] (c) the ranks resumed this process's one-step checkpoint (Adam step 1 -> {adam}); rank 0's "
        f"checkpoint after the bf16 step resumed in one process: step {step}, parameters bit for bit {same_params}, "
        f"Adam moments bit for bit {same_moments}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
    if not (same_params and same_moments and adam == [2] and step == 2):
        raise AssertionError("dist (c): a checkpoint did not resume across topologies")
    return rank_launches, readings


def dist_phase(dev, cd, cfg, paths, seed_ckpt: str, tmp: str) -> dict:
    """Data-parallel training at flagship width (ROADMAP A7), on phase 19's tree and its seeded
    checkpoint.  (a) ``python -m torch.distributed.run --nproc_per_node 1`` runs ``cli --dist`` (NCCL,
    world size 1) in a child (``dist_child``): ``DIST_HOST_STEPS`` host-sampled and
    ``DIST_DEVICE_STEPS`` device-sampled steps, the PDE terms from step ``DIST_PDE_START`` + 1; holds
    the logged losses finite, the child's v4s launches to ``v4s_launches_expected`` and every lead time
    of the host-sampled loss snapped to the 24-hour window (the device-sampled loss's unsnapped).
    (b) Two ranks on the one card over gloo (``parallel/dryrun.py::launch``, named explicitly) each run
    one PDE step on its window of a seeded two-window batch, float32 with TF32 off and bf16, held to
    this process's step over both windows from the same state (losses at ``RTOL_STEP``, parameters by
    ``DIST_PARAM_SHARE``), the ranks' metrics equal, two v4s forward and backward launches in each rank.
    (c) The ranks start from a one-process checkpoint (this process's state after one step, with its
    Adam moments) and rank 0's checkpoint after the bf16 step resumes here in one process, its
    parameters and Adam state bit for bit.  Prints each part's readings; returns the launch counts."""
    t_phase = time.perf_counter()
    got = dist_nccl_part(cfg, paths, seed_ckpt, tmp)
    rank_launches, readings = dist_gloo_part(dev, cd, cfg, seed_ckpt, tmp)
    log(f"[dist] phase 24 in {time.perf_counter() - t_phase:.1f} s")
    fwd = got["host"][0] + got["device"][0] + sum(a[0] + b[0] for a, b in rank_launches)
    bwd = got["host"][1] + got["device"][1] + sum(a[1] + b[1] for a, b in rank_launches)
    return dict(counts={"fused_decode_jvp_v4s": fwd, "decode_bwd_kernel_v4s": bwd}, child=got, ranks=rank_launches,
                readings=readings)


# phase 24b: the port's kernel paths at flagship width against the JAX package's record
PARITY_KERNELS = ("decode_primal_v4t", "fused_decode_jvp_v4s", "decode_bwd_kernel_v4s")  # rows 5, 12, 13


def parity_phase(dev) -> dict:
    """The kernel paths at flagship width held to the JAX package's numbers
    (``deepphysinet_tpu_torch/diagnostics/flagship_record.npz``, which the JAX package writes on the
    CPU): the weights and inputs that ``flagship_parity`` makes from the record's seed must give its
    checksums; then ``port_readings`` on the card (the ``'kernel'`` engine, version 7), float32 with
    TF32 off and bf16, each reading held to the record's at its bar (``flagship_parity.compare``),
    the primal decode and both v4s kernels launched in each dtype.  Logs each reading's largest
    error beside its bar, and the port's B = 2 step against its two micro-batches beside what JAX's
    parted by (``flagship_parity.b2_micro_rows``, logged, not held).  Returns the launch counts, the
    rows and each dtype's seconds."""
    from deepphysinet_tpu_torch.diagnostics import flagship_parity as fp
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meta, record = fp.load_record()
    cfg = fp.flagship_config()
    template = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], device="cpu")
    sd = fp.seeded_state_dict(template, meta["seed"])
    inputs = fp.flagship_inputs(cfg, meta["seed"])
    bad = fp.checksum_mismatches(meta, fp.checksums(sd, inputs))
    log(f"[parity] record written by {meta['written_by']} (jax {meta['jax']}); {len(meta['checksums'])} "
        f"checksums of the weights and inputs, {len(bad)} differ")
    if bad:
        raise AssertionError(f"the seeded weights or inputs differ from the record's: {bad[:20]}")
    launches, rows_all, seconds = {}, [], {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        readings, launches[dtype] = fp.port_readings(cfg, sd, inputs, fp.DTYPES[dtype], device=dev)
        torch.cuda.synchronize()
        seconds[dtype] = time.perf_counter() - t0
        rows = fp.compare(readings, meta, record, dtype)
        rows_all += rows
        for line in fp.format_rows(rows):
            log(f"[parity] {line}")
        log(f"[parity] {dtype}: launches {launches[dtype]} in {seconds[dtype]:.1f} s")
        if dtype == "float32":  # the question of phase 24 (b): B = 2 against two micro-batches
            for line in fp.format_rows(fp.b2_micro_rows(readings, meta, record)):
                log(f"[parity] the port's B = 2 against its micro-batches beside JAX's: {line}")
        missing = [k for k in PARITY_KERNELS if launches[dtype][k] <= 0]
        if missing:
            raise AssertionError(f"parity ({dtype}): the kernel paths launched no {missing}")
    failed = [r for r in rows_all if not r["ok"]]
    log(f"[parity] phase 24b in {time.perf_counter() - t_phase:.1f} s; {len(rows_all) - len(failed)} of "
        f"{len(rows_all)} readings within their bars")
    if failed:
        raise AssertionError("the kernel paths part from the JAX record: "
                             + "; ".join(fp.format_rows(failed)))
    return dict(launches=launches, rows=rows_all, seconds=seconds)


def attention_and_encoder_timing(dev, cd, model, field, fh_norm: float, stage_builds: dict) -> dict:
    """CUDA-event times of the attention kernels (and one scaled_dot_product_attention call, the
    library yardstick the port never calls) and of the fused encoder kernel, each beside its plain
    version, the encoder also on the device alone and (bf16) by stage, from the builds of
    ``encoder_stages.start_builds``; PhysicsNet.encode against encode_fused by host clock and CUDA
    events."""
    import torch.nn.functional as F

    from deepphysinet_tpu_torch.diagnostics import encoder_stages as es
    from deepphysinet_tpu_torch.ops import attention as at
    from deepphysinet_tpu_torch.ops import encoder_kernel as ek

    out = {}
    g = torch.Generator().manual_seed(17)
    scale = 1.0 / ATTN_HEAD_DIM ** 0.5
    for name, n in ATTN_TIMED:
        wrapper, plain = getattr(at, name), getattr(at, name + "_ref")
        q, k, v = (torch.randn(1, n, ATTN_HEADS, ATTN_HEAD_DIM, generator=g).to(dev, cd) for _ in range(3))
        # 20 calls a run at every size: the host work of a run's first call, whose kernel starts on
        # an idle card, is not hidden, and over 5 calls it adds a fifth of it to each
        iters = 20
        k_ms, p_ms, _ = alternating_ms(lambda: wrapper(q, k, v, scale), lambda: plain(q, k, v, scale), iters)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)  # noqa: E731
        sdpa()
        lib_ms = statistics.median(cuda_ms(sdpa, iters) for _ in range(4))
        dev_ms, lib_dev_ms = device_ms(lambda: wrapper(q, k, v, scale), iters), device_ms(sdpa, iters)
        flops = 4.0 * n * n * ATTN_HEAD_DIM * ATTN_HEADS
        b_ = attention_bound(n, ATTN_HEAD_DIM, ATTN_HEADS, 4 * tensor_bytes(q))
        out[(name, n)] = dict(ms=k_ms, plain=p_ms, library=lib_ms, device=dev_ms, library_device=lib_dev_ms,
                              bound=(b_["ms"], b_["by"]), bound_terms=b_["terms"])
        log(f"[timing] {name} at L={n} {cd}: kernel {k_ms:.4f} ms a call, {dev_ms:.4f} ms on the device alone "
            f"({flops / dev_ms / 1e9:.3f} TFLOP/s); plain {p_ms:.4f} ms; scaled_dot_product_attention {lib_ms:.4f} "
            f"ms a call, {lib_dev_ms:.4f} on the device; bound {b_['ms']:.5f} ms ({b_['term']}; "
            + ", ".join(f"{t} {v:.5f}" for t, v in b_["terms"].items()) + " ms)")
    net = model.meta_net.model
    act = net.encoder.attn_layers[0].activation
    w = ek.cast_encoder_weights(ek.extract_encoder_weights(model), cd)
    fh = torch.tensor([[fh_norm]], device=dev)
    with torch.no_grad():
        x = net.enc_embedding(field.float(), fh, net.learnable_token)[0]
    # the bf16 kernel's packed weight tiles, made once as encode_fused makes them for a batch
    packed = ek.pack_encoder_weights(w) if cd == torch.bfloat16 else None
    k_ms, p_ms, times = alternating_ms(lambda: ek.fused_encoder_forward(w, x, act, cd, packed),
                                       lambda: ek.fused_encoder_forward_ref(w, x, act, cd), 10)
    n_l, n_h, d, e = w.wq.shape
    length, f, c = x.shape[0], w.w1.shape[-1], w.wproj.shape[-1]
    flops = 2.0 * length * (n_l * (3 * d * n_h * e + 2 * length * n_h * e + n_h * e * d + 2 * d * f) + d * c)
    b_ = bound(flops, tensor_bytes(x, *w) + 4 * length * c)
    dev_ms = device_ms(lambda: ek.fused_encoder_forward(w, x, act, cd, packed), 20)
    # the stages by difference: each variant drops one stage's units (every barrier kept), timed on
    # the device alone in turns with the kernel itself (diagnostics/encoder_stages.py)
    runs, stage_ms = {}, {}
    if cd == torch.bfloat16:
        libs = es.load_builds(stage_builds, ek, ek._library())
        runs, stage_ms = es.stage_split(ek, libs, lambda: ek.fused_encoder_forward(w, x, act, cd, packed))
    out["encoder"] = dict(ms=k_ms, plain=p_ms, bound=b_, device_ms=dev_ms, stage_ms=stage_ms)
    log(f"[timing] fused encoder kernel at L={length} {cd}: kernel {k_ms:.4f} ms a call, {dev_ms:.4f} ms on the "
        f"device alone ({flops / dev_ms / 1e9:.3f} TFLOP/s), plain {p_ms:.4f} ms, bound {b_[0]:.5f} ms ({b_[1]}, "
        f"{flops / 1e9:.3f} GFLOP, {tensor_bytes(x, *w) / 1e6:.2f} MB in); runs kernel "
        f"{[round(t, 4) for t in times['kernel']]}")
    if stage_ms:
        log(f"[timing] fused encoder kernel at L={length} {cd}, on the device alone: the full kernel "
            f"{[round(t, 4) for t in runs['kernel']]} ms; by difference from builds without a stage's units: "
            + "; ".join(f"{name} {ms:.4f} ms" for name, ms in stage_ms.items()))

    def encode():
        with torch.no_grad():
            model.encode(field, fh)

    def fused():
        ek.encode_fused(model, field, fh)

    enc_ms, fused_ms, _ = alternating_ms(encode, fused, 10)
    encode_host = statistics.median([host_ms(encode) for _ in range(5)][1:])
    fused_host = statistics.median([host_ms(fused) for _ in range(5)][1:])
    out["encode"] = dict(encode_ms=enc_ms, fused_ms=fused_ms, encode_host=encode_host, fused_host=fused_host)
    log(f"[timing] one flagship encode (B = 1, {cd}): PhysicsNet.encode {enc_ms:.4f} ms, encode_fused {fused_ms:.4f} ms "
        f"by CUDA events; {encode_host:.3f} and {fused_host:.3f} ms by host clock (median of 4)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from deepphysinet_tpu_torch import native
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.diagnostics import encoder_stages
    from deepphysinet_tpu_torch.eval import common as eval_common
    from deepphysinet_tpu_torch.eval.residuals import evaluate_residuals, residual_field_maps
    from deepphysinet_tpu_torch.eval.rmse import evaluate_rmse_fullgrid
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import cuda_build
    from deepphysinet_tpu_torch.ops.coords import coriolis
    from deepphysinet_tpu_torch.ops import attention as at
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.ops import encoder_kernel as ek
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
    sources = dk.SOURCES + (rk.SOURCE, at.SOURCE, ek.SOURCE)
    t0 = time.perf_counter()
    enc_stage_builds = encoder_stages.start_builds(cuda_build, ek.SOURCE)  # read in the timing phase
    cuda_build.build_libraries(sources)
    dk._library()
    for source in dk.SOURCES[1:]:
        dk._jvp_library(source)
    rk._library()
    at._library()
    ek._library()
    log(f"[build] {', '.join(sources)} built together and loaded in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if not native.available():  # the host data layer's C++ kernels (native/src/dpn_native.cc), by g++
        raise AssertionError(f"the native host library did not build: {native.BUILD_ERROR}")
    log(f"[build] native/src/dpn_native.cc built with g++ and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{native.library_path()}")
    for source in sources:
        if source == at.SOURCE:
            continue
        for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {source}: {line.strip()}")
    for kernel, report in attention_ptxas(cuda_build.BUILD_LOGS.get(at.SOURCE, "")):
        log(f"[build] {at.SOURCE}: {kernel}: {report} (dynamic shared memory per launch: [attention] lines)")

    # ---- set-up: flagship model, window and batch ---------------------------------
    cfg = Config.fromfile(FLAGSHIP_CFG)["config"]
    cd = torch.bfloat16 if cfg["train_cfg"]["tpu"]["compute_dtype"] == "bfloat16" else torch.float32
    state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                  torch.Generator().manual_seed(0), compute_dtype=cd, device=dev,
                                  attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
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
        for n in PRIMAL_SIZES:
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
        if keep is not None:  # where keep leaves no point (N = 1 near a kink) there is nothing to compare
            p, t, p0, t0_ = p[:, keep], t[:, :, keep], p0[:, keep], t0_[:, :, keep]
        e_p, s_p = amax(p - p0), amax(p0)
        lim_p = TOL[dtype] * (1.0 + s_p)
        ok = ok and e_p <= lim_p
        e_t = []
        for k in range(3):
            e, s_ = amax(t[k] - t0_[k]), amax(t0_[k])
            e_t.append(e / s_ if s_ else e)
            ok = ok and e <= TOL_TANGENT[dtype] * s_
        log(f"[{what}] {str(dtype):15s} N={n:6d}: primal max|kernel-plain| {e_p:.3e} (max|plain| "
            f"{s_p:.3f}, bound {lim_p:.3e}); tangents x, y, t relative to their largest: "
            + ", ".join(f"{e:.2e}" for e in e_t) + f" (bound {TOL_TANGENT[dtype]:.0e}){extra}")
        if not ok:
            raise AssertionError(f"{what} kernel disagrees with its plain version ({dtype}, N={n})")
        return max(e_p, amax(t - t0_)), max(e_p / (1.0 + s_p), *e_t)

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

    # The decode is not continuous in its sums (see KINK_EPS): the forward checks leave out the
    # points with a relu argument near zero
    def near_kink(fw, pe, w1, cd_pe, dtype):
        """[N] bool: the points with a relu argument of the plain version near zero (KINK_EPS);
        ``pe`` [N, in_ch] and ``w1`` [6, in_ch, hid] are the primal operand and its layer-1 rows."""
        z = dk.dot_f32(pe, w1, dtype) + fw.b1[:, None, :]  # [6, N, hid]
        near = (z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
        r = (dk.dot_f32(torch.relu(z), fw.w2f1, dtype) + dk.dot_f32(cd_pe, fw.wdf1, dtype)
             + fw.rbias[:, None, :])
        return near | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0)

    def rounding_reading(what, fw, pe, w1, tins, w1k, cd_pe, t0_):
        """The rounding the bf16 tensor-core forward kernels follow (csrc/decode_jvp_tc.cuh,
        fix_ties), a reading held to nothing: the plain version's z and u_k are one FMA a term in
        k order, and any other sum flips some T(p) roundings, which switch tangent terms through
        r's relu mask.  ``pe`` [N, in_ch] by ``w1`` [6, in_ch, hid] is layer 1; ``tins[k]`` [N, ch]
        by ``w1k[:, k]`` the tangent rows; ``t0_`` the plain version's var-major tangents."""
        bf = torch.bfloat16
        with torch.no_grad():
            def sequential(x, y):  # x [N, K] @ y [V, K, H], one rounding a term in k order
                x, y = x.to(bf).float(), y.to(bf).float()  # bf16 products are exact in f32
                s = torch.zeros(y.shape[0], x.shape[0], y.shape[2], device=dev)
                for k in range(x.shape[1]):
                    s = s + x[None, :, k, None] * y[:, None, k, :]
                return s

            z = dk.dot_f32(pe, w1, bf)
            differ_seq = int((sequential(pe, w1) != z).sum())
            differ_u = sum(int((sequential(tins[k], w1k[:, k]) != dk.dot_f32(tins[k], w1k[:, k], bf)).sum())
                           for k in range(3))

            def dot64(x, y):
                return torch.matmul(x.to(bf).double(), y.to(bf).double()).float()

            z += fw.b1[:, None, :]
            z64 = dot64(pe, w1) + fw.b1[:, None, :]
            differ_tp = int((torch.relu(z).to(bf) != torch.relu(z64).to(bf)).sum())
            near = near_kink(fw, pe, w1, cd_pe, bf)
            p64 = torch.relu(z64)
            t64 = torch.stack([torch.where(z64 > 0, dot64(tins[k], w1k[:, k]), 0.0) for k in range(3)]).to(bf).float()
            r64 = dot64(p64, fw.w2f1) + dot64(cd_pe, fw.wdf1) + fw.rbias[:, None, :]
            to64 = ((torch.where((r64 > 0)[None], dot64(t64, fw.w2f1[None]), 0.0) * fw.fw2[None, :, None, :]).sum(-1)
                    + 2.0 * (t64 * fw.w2wo[None, :, None, :]).sum(-1))
            past = torch.zeros_like(near)
            for k in range(3):
                past |= ((to64[k] - t0_[k]).abs() > TOL_TANGENT[bf] * t0_[k].abs().max()).any(0)
            log(f"[rounding] {what}, bf16: cuBLAS's z differs from one FMA a term in k order at {differ_seq} "
                f"of {z.numel()} elements, its u_k at {differ_u} of {3 * z.numel()}; with float64 sums {differ_tp} "
                f"T(p) elements round the other way, "
                f"and {int((past & ~near).sum())} points' tangents then move past {TOL_TANGENT[bf]:.0e} of their "
                f"largest outside the kink set")
            del z, z64, p64, t64, r64, to64
        torch.cuda.empty_cache()

    def v4s_w1(fw6):  # the primal layer-1 rows of the v4s / v6 weights, [6, in_ch, hid]
        return fw6.w1g.reshape(n_vars, -1, fw6.w1g.shape[-1])

    def first_rows(n, largest, p, t, point_axis):
        """The C36 check: a call on the first n points gives the largest call's first n rows (the
        points' axis ``point_axis`` of p, the next of t) bit for bit; returns the log text."""
        if largest is None:
            return ""
        p1, t1 = largest
        same = torch.equal(p, p1.narrow(point_axis, 0, n)) and torch.equal(t, t1.narrow(point_axis + 1, 0, n))
        if not same:
            raise AssertionError(f"the kernel's rows at N={n} differ from the N={p1.shape[point_axis]} call's")
        return f"; the first {n} rows of the N={p1.shape[point_axis]} call bit-equal: {same}"

    # ---- 4. v4s forward kernel against plain version -------------------------------------------
    fwd_err, fwd_rel, bwd_err, bwd_rel = {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        fw6, pe_all, cd_all, ref_all = v4s_inputs(V4S_SIZES[0], dtype)
        largest = None
        for n in V4S_SIZES:
            pe_cm, cd_pe, ref_t = pe_all[:n].contiguous(), cd_all[:n].contiguous(), ref_all[:, :n].contiguous()
            near = near_kink(fw6, pe_cm, v4s_w1(fw6), cd_pe, dtype)
            left_out = f"; {int(near.sum())} of {n} points near a relu's kink left out"
            if n in KINK_SHARE_SIZES and int(near.sum()) > max(1, KINK_SHARE * n):
                raise AssertionError(f"v4s checks: {left_out} ({dtype})")
            p, t = dk.fused_decode_jvp_v4s(fw6, pe_cm, cd_pe, ref_t, dtype)
            torch.cuda.synchronize()
            left_out += first_rows(n, largest, p, t, 1)
            largest = largest or (p, t)
            p0, t0_ = dk.decode_jvp_v4s_ref(fw6, pe_cm, cd_pe, ref_t, dtype)
            fwd_err[(dtype, n)], fwd_rel[(dtype, n)] = forward_check("forward", dtype, n, p, t, p0, t0_, left_out,
                                                                     keep=~near)

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

    # the rounding the bf16 v4s kernels follow, on the step's larger launch
    fw6, pe_cm, cd_pe, ref_t = v4s_inputs(20480, torch.bfloat16)
    two_f_ = fw6.w1t.shape[2]
    rounding_reading("20,480 points of the v4s pair", fw6, pe_cm, v4s_w1(fw6),
                     [pe_cm[:, k * two_f_:(k + 1) * two_f_] for k in range(3)], fw6.w1t, cd_pe,
                     dk.decode_jvp_v4s_ref(fw6, pe_cm, cd_pe, ref_t, torch.bfloat16)[1])
    del fw6, pe_cm, cd_pe, ref_t

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
                      6: ("decode_jvp_v6_ref", dk.fused_decode_jvp_v6),  # [N, 6]: the only layout of 6
                      2: ("fused_decode_jvp_trainable", dk.fused_decode_jvp)}  # the 'kernel' route of 2

    def kernel_rounding_v6(fw, trig, cd_pe, ref, cdt, round_tangents=True):
        """The v6 plain forward as the kernel rounds: whatever the engine asks for."""
        return dk.decode_jvp_v6_ref(fw, trig.to(cdt), cd_pe.to(cdt), ref, cdt, round_tangents=True)

    def plain_v2(weights, pe, dpe, cd_pe, ref, cdt):
        """The v2 plain version as FusedDecodeJvpV2 is differentiated (see NOISE_TIMES): the
        values with the kernel's rounding, the gradient of the XLA twin's (C19)."""
        p, t = dk.decode_jvp_v2_ref(weights, pe, dpe, cd_pe, ref, cdt, round_wo=False)
        with torch.no_grad():
            p_k, t_k = dk.decode_jvp_v2_ref(weights, pe, dpe, cd_pe, ref, cdt)
        return p_k + (p - p.detach()), t_k + (t - t.detach())

    def plain_v2_kernel_rounding(weights, pe, dpe, cd_pe, ref, cdt):
        """The v2 plain version with the kernel's rounding in the values and the gradient."""
        return dk.decode_jvp_v2_ref(weights, pe, dpe, cd_pe, ref, cdt)

    def engine_gradients(model_, name, version=7):
        twin = copy.deepcopy(model_)
        attr, kernel_fn = plain_forwards[version]
        plain_forward = getattr(engine, attr)
        if name == "jvp twin":  # the step's own 'jvp' under kernel_version=6
            name = "jvp"
        elif version == 6 and name != "kernel":
            setattr(engine, attr, kernel_rounding_v6)
        elif version == 2 and name in ("jvp", "jvp on kernel forward"):
            setattr(engine, attr, plain_v2)
        elif version == 2 and name == "jvp kernel rounding":
            setattr(engine, attr, plain_v2_kernel_rounding)
            name = "jvp"
        if name == "jvp on kernel forward":
            setattr(engine, attr, on_kernel_forward(getattr(engine, attr), kernel_fn))
            name = "jvp"
        if version == 2 and name == "jvp":  # the kernel engine's route, with the plain version
            name = "kernel"
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

    def report_c19(model_, label, start_v2):
        """The gradient of one kernel_version=2 PDE step through the v2 plain version with the
        kernel's rounding of wo, against the twin's gradient that the step takes (C19): printed."""
        g_r = engine_gradients(model_, "jvp kernel rounding", 2)[2]
        g_x, noise = start_v2["jvp"], start_v2["noise"]
        rel = {k: float((g_r[k] - g_x[k]).abs().max()) / float(g_x[k].abs().max()) for k in g_x if k not in noise}
        top = sorted(rel, key=rel.get, reverse=True)[:3]
        log(f"[train v2] one PDE step, {label}, kernel_version=2: the gradient of the kernel's rounding of wo "
            f"against the twin's (C19) differs per parameter by at most {rel[top[0]]:.2e} of its largest entry ("
            + ", ".join(f"{k} {rel[k]:.1e}" for k in top) + "); not held")

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
                rk.fused_residual_sums_v6, at.attention_tile, at.attention_flash, ek.fused_encoder_forward,
                dk.fused_decode_jvp, dk.fused_decode_jvp_v3, dk.fused_decode_jvp_v4pe, dk.fused_decode_jvp_v5)

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
    start[(cd, 2)] = compare_engines(model, f"{cd} compute", *RTOL_STEP[cd], version=2)
    compare_versions(start[(cd, 2)], start[(cd, 7)], f"{cd} compute", cd, other=2)
    report_c19(model, f"{cd} compute", start[(cd, 2)])
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
        start[(f32, 2)] = compare_engines(model32, "float32 compute", *RTOL_STEP[f32], version=2)
        compare_versions(start[(f32, 2)], start[(f32, 7)], "float32 compute", f32, other=2)
        report_c19(model32, "float32 compute", start[(f32, 2)])
        compare_linearize(model32, "float32 compute", f32, start[(f32, 7)]["loss_jvp"])
        del model32
    if any(launch_counts()[k] == counts[k] for k in (
            "fused_decode_jvp_v4s", "decode_bwd_kernel_v4s", "fused_decode_jvp_v4t", "decode_bwd_kernel_v4t",
            "fused_decode_jvp_v6", "decode_bwd_kernel_v6", "fused_decode_jvp")):
        raise AssertionError("the 'kernel' engine launched no kernel")
    noise_v7 = start[(cd, 7)]["noise"]  # phase 15 reads it
    del start
    state4 = copy.deepcopy(state)  # the seeded state, before any update: phase 9 steps from it
    state6 = copy.deepcopy(state)  # and phase 12
    state2 = copy.deepcopy(state)  # and phase 14
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
    # the weights have taken training steps whose atomic adds differ from run to run: the points
    # near a relu's kink, where the kernel's mask may differ from autograd's, carry no cotangent
    near = near_kink(ins[0], ins[1], ins[0].w1, ins[3], f32)
    g_p[:, near], g_t[:, :, near] = 0.0, 0.0
    function_check("v4 backward [6, N]", ins[0], [*ins[1:], ref_t], g_p, g_t,
                   lambda w, *pts: dk.fused_decode_jvp_v4t_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v4_ref(w, *pts, f32, t_layout=True),
                   dk.fused_decode_jvp_v4t, dk.decode_bwd_kernel_v4t)
    function_check("v4 backward [N, 6]", ins[0], [*ins[1:], ref_n], g_p.t().contiguous(),
                   g_t.transpose(1, 2).contiguous(),
                   lambda w, *pts: dk.fused_decode_jvp_v4_kbwd(w, *pts, f32),
                   lambda w, *pts: dk.decode_jvp_v4_ref(w, *pts, f32),
                   dk.fused_decode_jvp_v4, dk.decode_bwd_kernel_v4)

    # The rounding the bf16 v4 kernel follows (csrc/decode_jvp_tc.cuh, fix_ties): a reading
    fw, pe, dpe, cd_pe, ref_t = frame_inputs(6.5, torch.bfloat16, with_tangents=True)
    rounding_reading("one frame", fw, pe, fw.w1, dpe, fw.w1c, cd_pe,
                     dk.decode_jvp_v4_ref(fw, pe, dpe, cd_pe, ref_t, torch.bfloat16, t_layout=True)[1])
    del fw, pe, dpe, cd_pe, ref_t
    torch.cuda.empty_cache()

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
        fw6, trig_all, cd_all, ref_all, pe_all, ref_t_all = v6_inputs(V4S_SIZES[0], dtype)
        largest = None
        for n in V4S_SIZES:
            trig, cd_pe, ref = trig_all[:, :n].contiguous(), cd_all[:n].contiguous(), ref_all[:n].contiguous()
            pe_cm, ref_t = pe_all[:n].contiguous(), ref_t_all[:, :n].contiguous()
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
            near = near_kink(fw6, pe_cm, v4s_w1(fw6), cd_pe, dtype)
            if n in KINK_SHARE_SIZES and int(near.sum()) > max(1, KINK_SHARE * n):
                raise AssertionError(f"v6 checks: {int(near.sum())} of {n} points near a relu's kink ({dtype})")
            rows = first_rows(n, largest, p, t, 0)
            largest = largest or (p, t)
            v6_fwd_err[(dtype, n)], v6_fwd_rel[(dtype, n)] = forward_check(
                "v6 forward", dtype, n, p.t(), t.transpose(1, 2), p0.t(), t0_.transpose(1, 2),
                f"; bit-equal to the v4s kernel on the same points; {int(near.sum())} of {n} points near a "
                "relu's kink left out" + rows, keep=~near)
            g_p, g_t = cotangents(n, seed=n + 2)
            g_p[:, near], g_t[:, :, near] = 0.0, 0.0
            g_p, g_t = point_major(g_p, g_t)
            got = dk.decode_bwd_kernel_v6(fw6, trig, cd_pe, g_p, g_t, dtype)
            again = dk.decode_bwd_kernel_v6(fw6, trig, cd_pe, g_p, g_t, dtype)
            torch.cuda.synchronize()
            want = dk.decode_bwd_v6_ref(fw6, trig, cd_pe, g_p, g_t, dtype)
            v6_bwd_err[(dtype, n)], v6_bwd_rel[(dtype, n)] = backward_check("v6 backward", dtype, n, got, want, again)
            del p0, t0_, got, again, want
    fw6, trig, cd_pe, ref, pe_cm, _ = v6_inputs(1000, f32)
    g_p, g_t = cotangents(1000, seed=9)
    near = near_kink(fw6, pe_cm, v4s_w1(fw6), cd_pe, f32)  # as for v4
    g_p[:, near], g_t[:, :, near] = 0.0, 0.0
    function_check("v6 backward", fw6, [trig, cd_pe, ref], *point_major(g_p, g_t),
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

    def relative(got_: float, want_: float) -> float:
        """|got - want| / |want|, for the log: 0 where both are 0 (a sum over a few points may be),
        inf where only want is."""
        return 0.0 if got_ == want_ else abs(got_ - want_) / abs(want_) if want_ else float("inf")

    def within(got_: float, want_: float, rtol: float, extra: float = 0.0) -> bool:
        """|got - want| <= rtol |want| + extra: a relative bound, with an absolute allowance (the terms
        of the points near a switch) that holds where want is 0 too."""
        return abs(got_ - want_) <= rtol * abs(want_) + extra

    resid_err, resid_rel, switch_moved, finite_points = {}, {}, {}, {}
    residual_fns = {4: (rk.fused_residual_sums_v4, rk.residual_sums_v4_ref, dk.decode_jvp_v4_ref,
                        dk.fused_decode_jvp_v4),
                    6: (rk.fused_residual_sums_v6, rk.residual_sums_v6_ref, dk.decode_jvp_v6_ref,
                        dk.fused_decode_jvp_v6)}
    decode_bits = [0, 0, 0]  # points sampled; the kernel's term equal to the forward kernel's; to the plain's
    for n in RESIDUAL_SIZES:
        coords, nwp, cor = window_points(n, seed=n)
        for version, fns in residual_fns.items():
            decode_ref = fns[2]
            for dtype in (torch.bfloat16, torch.float32):
                all_ins = residual_inputs(version, coords, nwp, dtype)
                for with_clip in (True, False):
                    # Without the clip a model of random weights gives unphysical fields, and the
                    # Tetens formula is singular at T = 29.65 K and overflows below it: there the
                    # vapor term is inf / inf, and near it it amplifies the decode's last bits.
                    # So the no-clip runs leave out the points whose plain p or T lies outside its
                    # physical bounds (u, v, q and rho stay as wild as they come), and every run
                    # the points whose terms are not finite (with the clip, at the pole of q_s,
                    # p = 0.378 e_s, which lies inside the bounds); the rest is a ragged size of
                    # its own.
                    ins, cor_, dropped = all_ins, cor, 0
                    primal, tang = decode_ref(*ins, dtype)
                    keep = torch.isfinite(rk.residual_point_terms(primal, tang, cor, scfg.obs_specs, with_clip)).all(0)
                    if not with_clip:
                        for v_ in (2, 3):
                            spec = scfg.obs_specs[v_]
                            phys = primal[:, v_] * spec.norm_factor[1] + spec.norm_factor[0]
                            keep &= (phys > spec.bound[0]) & (phys < spec.bound[1])
                    if not bool(keep.any()):  # at the smallest sizes the no-clip run may keep no point
                        log(f"[residual] v{version} {str(dtype):15s} N={n:6d} clip={with_clip!s:5s}: all points "
                            "left out, nothing to hold")
                        continue
                    if not bool(keep.all()):
                        dropped, cor_ = int((~keep).sum()), cor[keep].contiguous()
                        ins = point_subset(ins, keep)
                    chk = residual_check(rk, engine, scfg, fns, ins, cor_, with_clip, dtype, RTOL_RESIDUAL[dtype])
                    got, want, moved = chk["got"], chk["want"], chk["moved"]
                    rel = [relative(g_, w_) for g_, w_ in zip(got.tolist(), want.tolist())]
                    switch_moved[(version, dtype, with_clip)] = moved
                    if with_clip and dtype == cd:
                        finite_points[version] = keep
                    for i, k in enumerate(("sample", "bits_equal", "plain_equal")):
                        decode_bits[i] += chk[k]
                    # per equation within RTOL_RESIDUAL of the plain sum and the decode's allowance, the
                    # vapor sum also within the terms of the points near a switch; the limits as shares
                    # of the plain sums
                    limits = [relative(float(w_) + x_, float(w_)) + RTOL_RESIDUAL[dtype]
                              for w_, x_ in zip(want.tolist(), chk["extra"])]
                    worst = max(range(6), key=lambda e: rel[e] / limits[e] if limits[e] < float("inf") else 0.0)
                    log(f"[residual] v{version} {str(dtype):15s} N={n:6d} clip={with_clip!s:5s}: per equation "
                        f"|kernel-plain| / plain at most {rel[worst]:.2e} ({rk.EQUATIONS[worst]}; bound "
                        f"{limits[worst]:.1e}); two runs bit-equal: {torch.equal(got, chk['again'])}; kernel "
                        + " ".join(f"{x:.8g}" for x in got.tolist()) + "; plain "
                        + " ".join(f"{x:.8g}" for x in want.tolist()) + "; float64 sum of the plain terms "
                        + " ".join(f"{x:.8g}" for x in chk["exact"].tolist()) + "; of the forward kernel decode's terms "
                        + " ".join(f"{x:.8g}" for x in chk["exact_k"].tolist())
                        + f"; {chk['n_near']} points near a switch of the vapor term ({SWITCH_EPS[dtype]:.0e} of "
                        f"delta's, {KINK_EPS:.0e} of a bound), their vapor terms at most {moved:.3g}; the decode's "
                        f"allowance: {allowance_text(chk, RTOL_RESIDUAL[dtype])}; the kernel's term at "
                        f"{chk['sample']} points equals the forward kernel's decode's at {chk['bits_equal']} (the "
                        f"plain decode's at {chk['plain_equal']}); {dropped} points left out")
                    if not (got.shape == (6,) and bool(torch.isfinite(got).all()) and torch.equal(got, chk["again"])
                            and all(chk["ok"])):
                        raise AssertionError(f"residual-sum kernel v{version} disagrees with its plain version "
                                             f"({dtype}, N={n}, with_clip={with_clip}): {rel} > {limits}")
                    if with_clip:
                        resid_err[(version, dtype, n)] = float((got - want).abs().max())
                        resid_rel[(version, dtype, n)] = rel[worst]
                    del chk
                del primal, tang, ins, all_ins
        # the in-kernel path against the split path on the same points, through the entry points:
        # those of the residual check above (whose terms are finite in the plain decode)
        for version in (4, 6):
            keep = finite_points[version]
            pts = (coords, nwp, cor) if bool(keep.all()) else tuple(x[keep].contiguous() for x in (coords, nwp, cor))
            args = (model, tokens_w, pts[0], pts[1], fh_w, pts[2], scfg.coord_spec, scfg.obs_specs, unit)
            crossover = engine.FUSED_ASSEMBLY_MIN_N
            engine.FUSED_ASSEMBLY_MIN_N = 10**9  # version 6: the split branch at any size
            try:
                split = engine.fused_residual_losses(*args, version=version)
            finally:
                engine.FUSED_ASSEMBLY_MIN_N = crossover
            fused = rk.kernel_residual_losses(*args, version=version)
            want = {k: float(split[k]) for k in LOSS_KEYS}
            rel = {k: relative(float(fused[k]), w_) for k, w_ in want.items()}
            worst = max(rel, key=rel.get)
            n_kept = int(keep.sum())
            # with unit factors a loss is its equation's sum over the points, over their number
            vapor_moved = switch_moved[(version, cd, True)] / max(n_kept, 1)
            vapor_limit = RTOL_RESIDUAL[cd] + relative(want["vapor_loss"] + vapor_moved, want["vapor_loss"])
            log(f"[residual] v{version} {cd} N={n:6d}: in-kernel assembly against the split path, per loss at most "
                f"{rel[worst]:.2e} ({worst}; bound {RTOL_RESIDUAL[cd]:.0e}), vapor {rel['vapor_loss']:.2e} (bound "
                f"{vapor_limit:.2e}, as above); {n - n_kept} points left out")
            if n_kept == 0 or not all(within(float(fused[k]), w_, RTOL_RESIDUAL[cd],
                                             vapor_moved if k == "vapor_loss" else 0.0) for k, w_ in want.items()):
                raise AssertionError(f"in-kernel assembly v{version} disagrees with the split path (N={n}): {rel}")
    del coords, nwp, cor, args, pts
    torch.cuda.empty_cache()
    log(f"[residual] the decode's bits: over all checks, the kernel's term at {decode_bits[0]} points (each a "
        f"launch of its own) equals the term of the forward kernel's decode at {decode_bits[1]}, of the plain "
        f"decode at {decode_bits[2]}")
    if decode_bits[1] != decode_bits[0]:  # the decode allowance takes the forward kernel's decode for the kernel's
        raise AssertionError(f"the residual-sum kernels' decode parts from the forward kernels' at "
                             f"{decode_bits[0] - decode_bits[1]} of {decode_bits[0]} points")

    # the entry points on both sides of the crossover, from counts of 0
    reset_launch_counts()
    entry = {}
    for label, fn, version, n in (
            ("fused_residual_losses(version=6), split branch", engine.fused_residual_losses, 6, RESIDUAL_SPLIT_N),
            ("fused_residual_losses(version=6), in-kernel", engine.fused_residual_losses, 6, RESIDUAL_MAIN_N),
            ("kernel_residual_losses(version=4)", rk.kernel_residual_losses, 4, RESIDUAL_MAIN_N),
            ("fused_residual_losses(version=2), split branch", engine.fused_residual_losses, 2, RESIDUAL_SPLIT_N),
            ("fused_residual_losses(version=2), in-kernel", engine.fused_residual_losses, 2, RESIDUAL_MAIN_N)):
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
    expected.update(fused_decode_jvp_v6=1, fused_residual_sums_v6=1, fused_residual_sums_v4=2, fused_decode_jvp=1)
    log(f"[residual] kernel launches of the residual entry points: {resid_launches} (expected one v6 and one v2 "
        f"forward below {engine.FUSED_ASSEMBLY_MIN_N} points, one in-kernel launch of each call above: version 2 "
        "takes the v4 residual kernel)")
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

    # ---- 13. the v2 and v3 kernels against their plain versions --------------------------------
    def v2_inputs(n: int, dtype):
        """Decode weights and the v2 inputs of the first n margin points (the step's launch)."""
        with torch.no_grad():
            fh_norm = (batch.forecast_h / scfg.forecast_time_period)[:, None]
            tokens = model.encode(batch.field, fh_norm)[0]
            m = batch.margin
            coords = torch.stack([m.x[0, :n], m.y[0, :n], m.t[0, :n]], dim=-1)
            weights, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens, coords, m.nwp[0, :n], fh_norm[0],
                                                            scfg.coord_spec)
        return weights, pe.to(dtype), dpe.to(dtype).contiguous(), cd_pe.to(dtype), m.nwp[0, :n].contiguous()

    def frame_points(time_h: float):
        """Decode weights, coordinates [N, 3] and conditioning values [N, 6] of one full-grid frame."""
        xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
        px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, time_h))
        fh_norm = window.forecast_h / dcfg.forecast_time_period
        with torch.no_grad():
            tokens = runner._encode(model, field, fh_norm)
            weights = dk.extract_decode_weights(model, tokens, torch.tensor([fh_norm], device=dev))
        return (weights, torch.from_numpy(np.stack([px, py, pt], -1)).to(dev).contiguous(),
                torch.from_numpy(nwp).to(dev).contiguous(), tokens, fh_norm)

    def near_kink_v2(w, pe, cd_pe, dtype):
        """[N] bool: the points with a relu argument (z or r) of the v2 plain version near zero
        (KINK_EPS), from the interleaved PE ``pe`` and the cd PE."""
        z = dk.dot_f32(pe, w.w1, dtype) + w.b1[:, None, :]
        c = (dk.dot_f32(torch.relu(z), w.w2, dtype) + w.b2[:, None, :]
             + (dk.dot_f32(cd_pe, w.wd, dtype) + w.bd[:, None, :]) + w.fh_add[:, None, :])
        r = dk.dot_f32(c, w.f1, dtype) + w.g1[:, None, :]
        return ((z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
                | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0))

    def front_end_operands(coords, cdata, in_ch, dtype):
        """The primal and cd operands that the plain versions of v3 and v4pe compute from raw
        coordinates and conditioning values (``pe_front_end``: float32, channel-major), rounded to
        ``dtype``, and the row permutations of layer 1 and of the cd weights that match them.
        The prepared PE of ``engine._kernel_inputs`` is rounded to the model's compute type, so in
        a float32 check its relu arguments are not the plain version's, and kink points slip out."""
        pe_cm, _, cd_cm = dk.pe_front_end(coords, cdata, dcfg.coord_spec, in_ch)
        perms = [torch.as_tensor(dk.channel_major_perm(in_ch, c), device=dev) for c in (3, 6)]
        return pe_cm.to(dtype), cd_cm.to(dtype), perms

    def kink_note(near, n, what, dtype):
        # at the block-edge sizes (v2's) the count is printed, not held to the share: see KINK_EPS
        if n not in BLOCK_EDGE_SIZES and int(near.sum()) > max(1, KINK_SHARE * n):
            raise AssertionError(f"{what} checks: {int(near.sum())} of {n} points near a relu's kink ({dtype})")
        return f"; {int(near.sum())} of {n} points near a relu's kink left out"

    def point_major_check(what, dtype, n, p, t, p0, t0_, near, extra="", firsts=None):
        """``forward_check`` on [N, 6] / [3, N, 6] outputs, the points near a kink left out.  With
        ``firsts`` (what -> the kernel's outputs at the loop's first and largest size, on inputs of
        which this call's are the first n), the outputs are also held to that call's first n rows
        bit for bit: a point's result does not hang on the points after it, and this holds the
        block edges where the kink rule leaves no point to compare (N = 1)."""
        same = True
        if firsts is not None and what in firsts:
            p1, t1 = firsts[what]
            same = torch.equal(p, p1[:n]) and torch.equal(t, t1[:, :n])
            extra += f"; the first {n} rows of the N={p1.shape[0]} call bit-equal: {same}"
        elif firsts is not None:
            firsts[what] = (p, t)
        out = forward_check(what, dtype, n, p.t(), t.transpose(1, 2), p0.t(), t0_.transpose(1, 2),
                            kink_note(near, n, what, dtype) + extra, keep=~near)
        if not same:
            raise AssertionError(f"{what} kernel's rows at N={n} differ from the larger call's ({dtype})")
        return out

    model.eval()
    variant_err, variant_rel = {}, {}  # (name, dtype, n) -> as forward_check returns
    for dtype in (torch.bfloat16, torch.float32):
        firsts = {}  # each kernel's outputs at its loop's first, largest size: see point_major_check
        w2_, pe, dpe, cd_pe, ref = v2_inputs(V2_SIZES[0], dtype)
        for n in V2_SIZES:
            ins = (pe[:n].contiguous(), dpe[:, :n].contiguous(), cd_pe[:n].contiguous(), ref[:n].contiguous())
            near = near_kink_v2(w2_, ins[0], ins[2], dtype)
            p, t = dk.fused_decode_jvp(w2_, *ins, dtype)
            torch.cuda.synchronize()
            p0, t0_ = dk.decode_jvp_v2_ref(w2_, *ins, dtype)
            variant_err[("fused_decode_jvp", dtype, n)], variant_rel[("fused_decode_jvp", dtype, n)] = \
                point_major_check("v2 forward", dtype, n, p, t, p0, t0_, near, firsts=firsts)
            del p0, t0_
        if dtype == torch.bfloat16:  # the rounding the bf16 v2 kernel follows, on the step's larger launch
            reading, not_seq = v2_rounding_reading(dk, w2_, pe, dpe, cd_pe, near_kink_v2(w2_, pe, cd_pe, dtype),
                                                   TOL[dtype], TOL_TANGENT[dtype])
            log(f"[rounding] v2, bf16, {pe.shape[0]} points: cuBLAS's sums of c (T(p) . w2, cd . wd) and r (T(c) . "
                f"f1) differ from one add a term in k order at {', '.join(str(x) for x in not_seq.values())} elements; "
                "with float64 sums in place of cuBLAS's at one rounding point, (elements that round the other way, "
                f"points past the bounds outside the kink set): " + ", ".join(f"{q} {v}" for q, v in reading.items()))
        w3, coords, nwp, _, _ = frame_points(6.5)
        pe3, cd3, (perm3, perm6) = front_end_operands(coords, nwp, w3.w1.shape[1], dtype)
        w3_cm = w3._replace(w1=w3.w1[:, perm3], wd=w3.wd[:, perm6])
        for n in V3_SIZES:
            near = near_kink_v2(w3_cm, pe3[:n], cd3[:n], dtype)
            c_, x_ = coords[:n].contiguous(), nwp[:n].contiguous()
            p, t = dk.fused_decode_jvp_v3(w3, c_, x_, scfg.coord_spec, dtype)
            p2, t2 = dk.fused_decode_jvp_v3(w3, c_, x_, scfg.coord_spec, dtype)
            torch.cuda.synchronize()
            same = torch.equal(p, p2) and torch.equal(t, t2)
            p0, t0_ = dk.decode_jvp_v3_ref(w3, c_, x_, scfg.coord_spec, dtype)
            variant_err[("fused_decode_jvp_v3", dtype, n)], variant_rel[("fused_decode_jvp_v3", dtype, n)] = \
                point_major_check("v3 forward", dtype, n, p, t, p0, t0_, near, f"; two runs bit-equal: {same}",
                                  firsts=firsts)
            if not same:
                raise AssertionError(f"two runs of the v3 kernel differ ({dtype}, N={n})")
            del p0, t0_, p2, t2
        if dtype == torch.bfloat16:  # the rounding the bf16 v3 kernel follows, on its channel-major operands
            in_ch_ = w3.w1.shape[1]
            t3 = dk.pe_front_end(coords, nwp, dcfg.coord_spec, in_ch_)[1].to(dtype)
            reading, not_seq = v2_rounding_reading(dk, w3_cm, pe3, t3, cd3, near_kink_v2(w3_cm, pe3, cd3, dtype),
                                                   TOL[dtype], TOL_TANGENT[dtype],
                                                   w1k=w3_cm.w1.reshape(n_vars, 3, in_ch_ // 3, -1))
            log(f"[rounding] v3, bf16, {pe3.shape[0]} points (channel-major): cuBLAS's sums of c (T(p) . w2, cd . "
                f"wd) and r (T(c) . f1) differ from one add a term in k order at "
                f"{', '.join(str(x) for x in not_seq.values())} elements; with float64 sums in place of cuBLAS's at "
                "one rounding point, (elements that round the other way, points past the bounds outside the kink "
                "set): " + ", ".join(f"{q} {v}" for q, v in reading.items()))
            del t3
        del pe, dpe, cd_pe, pe3, cd3
    torch.cuda.empty_cache()

    # FusedDecodeJvpV2 (kernel forward, plain backward) against autograd of the plain forward, f32:
    # the cotangents of every input, as JAX's custom VJP of the v2 kernel returns them
    w2_, pe, dpe, cd_pe, ref = v2_inputs(1000, f32)
    g_p, g_t = point_major(*cotangents(1000, seed=10))

    def v2_grads(fn):
        leaves = dk.DecodeWeights(*(x.detach().clone().requires_grad_(True) for x in w2_))
        pts = [x.detach().clone().requires_grad_(True) for x in (pe, dpe, cd_pe, ref)]
        p, t = fn(leaves, *pts)
        ((p * g_p).sum() + (t * g_t).sum()).backward()
        return [x.grad for x in (*leaves, *pts)]

    count = dk.fused_decode_jvp.launches
    g_k = v2_grads(lambda w, *a: dk.fused_decode_jvp_trainable(w, *a, f32))
    if dk.fused_decode_jvp.launches != count + 1:
        raise AssertionError("FusedDecodeJvpV2 did not launch the v2 forward kernel once")
    g_x = v2_grads(lambda w, *a: dk.decode_jvp_v2_ref(w, *a, f32, round_wo=False))
    rel = {name: float((a_ - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
           for name, a_, b_ in zip(dk.DecodeWeights._fields + ("pe", "dpe", "cd_pe", "ref"), g_k, g_x)}
    worst = max(rel, key=rel.get)
    log(f"[v2] FusedDecodeJvpV2 against autograd of the plain forward (f32, N=1000): every cotangent within "
        f"{rel[worst]:.2e} of its largest ({worst}; bound {RTOL_BWD[f32]:.0e})")
    if rel[worst] > RTOL_BWD[f32] or not torch.equal(g_k[-1], g_p):
        raise AssertionError(f"FusedDecodeJvpV2 disagrees with autograd of the plain forward: {rel}")
    del w2_, pe, dpe, cd_pe, ref, g_k, g_x

    # ---- 14. the training step under kernel_version=2 ------------------------------------------
    # (the engine and version comparisons of one PDE step ran in phase 6, at the seeded state)
    model.train()
    reset_launch_counts()
    step2 = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=2))
    before = [p.detach().clone() for p in state2.model.parameters()]
    for i in range(3):
        counts = launch_counts()
        state2, metrics = step2(state2, batch, True)
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        launched = {k: v - counts[k] for k, v in launch_counts().items() if v != counts[k]}
        log(f"[train v2] step {i} (pde, kernel_version=2): total {metrics['total_loss']:.6g}, margin "
            f"{metrics['margin_loss']:.6g}, grad_norm {metrics['grad_norm']:.6g}, kernel launches {launched}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad or metrics["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"train step (kernel_version=2): non-finite metrics {bad}")
        if launched != {"fused_decode_jvp": 2}:
            raise AssertionError(f"train step (kernel_version=2) launched {launched}")
    train2_launches = launch_counts()
    if state2.step != 3 or not all(bool((a_ != b_).any()) for a_, b_ in zip(before, state2.model.parameters())):
        raise AssertionError("a parameter did not change in the kernel_version=2 steps")
    del state2, before
    torch.cuda.empty_cache()

    # ---- 15. the v4pe and v5 kernels; the in_kernel_pe route; direct calls of v3 and v5 ---------
    model.eval()
    for dtype in (torch.bfloat16, torch.float32):
        firsts = {}
        fw, pe, dpe, cd_pe, ref_t = frame_inputs(6.5, dtype, with_tangents=True)
        _, coords, nwp, _, _ = frame_points(6.5)
        pe4, cd4, (perm3, perm6) = front_end_operands(coords, nwp, fw.w1.shape[1], dtype)
        fw_cm = fw._replace(w1=fw.w1[:, perm3], wdf1=fw.wdf1[:, perm6])
        for n in PE_SIZES:
            ins = (pe[:n].contiguous(), dpe[:, :n].contiguous(), cd_pe[:n].contiguous())
            ref = ref_t[:, :n].t().contiguous()
            near = near_kink(fw, ins[0], fw.w1, ins[2], dtype)  # v5's: the prepared operands
            near_pe = near_kink(fw_cm, pe4[:n], fw_cm.w1, cd4[:n], dtype)  # v4pe's own
            c_, x_ = coords[:n].contiguous(), nwp[:n].contiguous()
            p, t = dk.fused_decode_jvp_v4pe(fw, c_, x_, dcfg.coord_spec, dtype)
            p2, t2 = dk.fused_decode_jvp_v4pe(fw, c_, x_, dcfg.coord_spec, dtype)
            torch.cuda.synchronize()
            same = torch.equal(p, p2) and torch.equal(t, t2)
            p0, t0_ = dk.decode_jvp_v4pe_ref(fw, c_, x_, dcfg.coord_spec, dtype)
            variant_err[("fused_decode_jvp_v4pe", dtype, n)], variant_rel[("fused_decode_jvp_v4pe", dtype, n)] = \
                point_major_check("v4pe forward", dtype, n, p, t, p0, t0_, near_pe, f"; two runs bit-equal: {same}",
                                  firsts=firsts)
            if not same:
                raise AssertionError(f"two runs of the v4pe kernel differ ({dtype}, N={n})")
            del p2, t2
            p, t = dk.fused_decode_jvp_v5(fw, *ins, ref, dtype)
            torch.cuda.synchronize()
            p0, t0_ = dk.decode_jvp_v5_ref(fw, *ins, ref, dtype)
            variant_err[("fused_decode_jvp_v5", dtype, n)], variant_rel[("fused_decode_jvp_v5", dtype, n)] = \
                point_major_check("v5 forward", dtype, n, p, t, p0, t0_, near, firsts=firsts)
            del p0, t0_
        if dtype == torch.bfloat16:
            # the rows of the PE front ends, bit for bit: the tensor-core bodies' (one sincosf an angle)
            # against the CUDA-core bodies' (sinf, cosf), and their recompute's against their front end's
            for n in (GRID_POINTS, 129):
                rows_ = {f: dk.pe_front_end_rows(coords[:n].contiguous(), nwp[:n].contiguous(), dcfg.coord_spec,
                                                 fw.w1.shape[1], f) for f in dk.PE_FRONT_ENDS}
                torch.cuda.synchronize()
                other = [int((a != b).sum()) for a, b in zip(rows_["tensor_cores"], rows_["cuda_cores"])]
                again = [int((a != b).sum()) for a, b in zip(rows_["recompute"][:2], rows_["tensor_cores"][:2])]
                log(f"[pe rows] N={n}: the tensor-core front end's bf16 rows (one sincosf an angle) against the "
                    f"CUDA-core front end's (sinf, cosf): pe, tangents, cd differ at {other} of "
                    f"{[x.numel() for x in rows_['tensor_cores']]} elements; the recompute's pe and tangent rows "
                    f"against the front end's: {again}")
                if any(other) or any(again):
                    raise AssertionError(f"the PE front ends' rows differ: {other}, {again}")
            del rows_
        del fw, pe, dpe, cd_pe, ref_t
    torch.cuda.empty_cache()

    # one frame through fused_kernel_fields(in_kernel_pe=True), from counts of 0, against the same
    # call without it: the v4 kernel on the prepared PE, the same function with layer 1 summed over
    # the PE features in another order (channel-major against interleaved).  In bf16 a last-bit
    # change of z flips a few roundings of p and of the masked tangents, and where r lies that close
    # to a relu's kink a tangent term switches: the routes are held to STEP_TIMES_EXPLAINED times
    # what their plain versions differ by on the same points, or to TOL / TOL_TANGENT if larger
    w3, coords, nwp, tokens_f, fh_norm_f = frame_points(6.5)
    fh_f = torch.tensor([fh_norm_f], device=dev)
    reset_launch_counts()
    with torch.no_grad():
        p_pe, t_pe = engine.fused_kernel_fields(model, tokens_f, coords, nwp, fh_f, dcfg.coord_spec, dcfg.obs_specs,
                                                version=4, in_kernel_pe=True, raw_tangents=True)
    torch.cuda.synchronize()
    pe_launches = launch_counts()
    with torch.no_grad():
        p_v4, t_v4 = engine.fused_kernel_fields(model, tokens_f, coords, nwp, fh_f, dcfg.coord_spec, dcfg.obs_specs,
                                                version=4, raw_tangents=True)
        fw = dk.fuse_decode_weights(w3)
        pe, dpe, cd_pe = (*dk.pe_and_tangents(coords, dcfg.coord_spec, cd), engine._cd_pe(model, nwp))
        near = near_kink(fw, pe, fw.w1, cd_pe, cd)
        plain_routes = (*dk.decode_jvp_v4pe_ref(fw, coords, nwp, dcfg.coord_spec, cd),
                        *dk.decode_jvp_v4_ref(fw, pe, dpe, cd_pe, nwp, cd))

    def route_gap(p, t, p0, t0_):
        """Primal gap relative to 1 + its largest value, each tangent's relative to its largest,
        at the points away from a kink."""
        p, t, p0, t0_ = p[~near], t[:, ~near], p0[~near], t0_[:, ~near]
        return [float((p - p0).abs().max()) / (1.0 + float(p0.abs().max()))] + [
            float((t[k] - t0_[k]).abs().max()) / float(t0_[k].abs().max()) for k in range(3)]

    got, explained = route_gap(p_pe, t_pe, p_v4, t_v4), route_gap(*plain_routes)
    limits = [max(STEP_TIMES_EXPLAINED * e, (TOL if i == 0 else TOL_TANGENT)[cd]) for i, e in enumerate(explained)]
    log(f"[v4pe] fused_kernel_fields(in_kernel_pe=True) {cd} N={GRID_POINTS} against in_kernel_pe=False (the v4 "
        f"kernel): primal, tangents x, y, t {', '.join(f'{g:.2e}' for g in got)} (bounds "
        f"{', '.join(f'{l_:.2e}' for l_ in limits)}; the plain versions differ by "
        f"{', '.join(f'{e:.2e}' for e in explained)}){kink_note(near, GRID_POINTS, 'in_kernel_pe', cd)}; "
        f"launches {({k: v for k, v in pe_launches.items() if v})}")
    if not (all(g <= l_ for g, l_ in zip(got, limits)) and p_pe.shape == (GRID_POINTS, n_vars)
            and bool(torch.isfinite(p_pe).all() and torch.isfinite(t_pe).all())):
        raise AssertionError(f"fused_kernel_fields(in_kernel_pe=True) disagrees with the v4 route: {got} > {limits}")
    if {k: v for k, v in pe_launches.items() if v} != {"fused_decode_jvp_v4pe": 1}:
        raise AssertionError(f"fused_kernel_fields(in_kernel_pe=True) launched {pe_launches}")
    # v3 and v5 have their own entry points only, as in JAX: one direct call of each, from counts of 0
    reset_launch_counts()
    direct = {"fused_decode_jvp_v3": dk.fused_decode_jvp_v3(w3, coords, nwp, dcfg.coord_spec, cd),
              "fused_decode_jvp_v5": dk.fused_decode_jvp_v5(fw, pe, dpe, cd_pe, nwp, cd)}
    torch.cuda.synchronize()
    direct_launches = launch_counts()
    log(f"[v4pe] direct calls at N={GRID_POINTS}: launches {({k: v for k, v in direct_launches.items() if v})}; "
        + ", ".join(f"{k} primal mean {float(p.mean()):.4g}" for k, (p, _) in direct.items()))
    if {k: v for k, v in direct_launches.items() if v} != {"fused_decode_jvp_v3": 1, "fused_decode_jvp_v5": 1} \
            or not all(bool(torch.isfinite(p).all() and torch.isfinite(t).all()) for p, t in direct.values()):
        raise AssertionError(f"the direct calls of v3 and v5 launched {direct_launches}")
    del p_pe, t_pe, p_v4, t_v4, pe, dpe, cd_pe, direct, w3, coords, nwp, tokens_f, plain_routes
    model.train()
    torch.cuda.empty_cache()

    # ---- 16. the attention kernels ------------------------------------------------------------------
    attn_errs = attention_phase(dev)
    torch.cuda.empty_cache()

    # ---- 17. the fused encoder kernel and encode_fused ----------------------------------------------
    enc = encoder_phase(dev, model, field, window.forecast_h / dcfg.forecast_time_period, reset_launch_counts)

    # ---- 18. the entry points with attn_impl='pallas' and 'flash' ------------------------------------
    attn_launches = paths_phase(dev, cfg, cd, window, dcfg, scfg, field, batch, launch_counts,
                                reset_launch_counts, noise_v7)
    torch.cuda.empty_cache()

    # ---- 19. inference from disk: the host data layer, a checkpoint and the command line ----------
    import shutil
    import tempfile

    disk_tmp = tempfile.mkdtemp(prefix="dpn_disk_")
    try:
        disk_launches, disk_paths, disk_ckpt = disk_phase(dev, cd, cfg, native, disk_tmp)
        torch.cuda.empty_cache()

        # ---- 20. training from disk: the trainer, its resume and --mode test -------------------------
        trainer = trainer_phase(dev, cfg, disk_paths, disk_ckpt, disk_tmp, launch_counts, reset_launch_counts)
        torch.cuda.empty_cache()

        # ---- 21. training with the points sampled on the device: both samplers and a resume ---------
        device_trainer = device_trainer_phase(dev, cfg, disk_paths, disk_ckpt, disk_tmp, launch_counts,
                                              reset_launch_counts, trainer["host"])
        torch.cuda.empty_cache()

        # ---- 22. the tools: evaluate's modes, stations and products on phase 19's tree -------------
        tools = tools_phase(dev, cd, cfg, disk_paths, os.path.join(disk_tmp, "trainer_ckpt"), disk_tmp,
                            launch_counts, reset_launch_counts)
        torch.cuda.empty_cache()

        # ---- 22b. the ETL tools from raw GRIB2 and NetCDF, and the main path on the tree they write --
        etl = etl_phase(dev, cfg, disk_paths, disk_ckpt, disk_tmp, launch_counts, reset_launch_counts)
        torch.cuda.empty_cache()

        # ---- 23. the encoder's model options: ProbSparse attention and fused q/k/v through the paths --
        options = model_options_phase(dev, cd, cfg, window, dcfg, scfg, field, batch, disk_paths, disk_ckpt,
                                      disk_tmp, launch_counts, reset_launch_counts)
        torch.cuda.empty_cache()

        # ---- 24. data-parallel training: NCCL at world size 1, two gloo ranks, checkpoints across ------
        dist = dist_phase(dev, cd, cfg, disk_paths, disk_ckpt, disk_tmp)
    finally:
        shutil.rmtree(disk_tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 24b. the kernel paths at flagship width against the JAX package's record ---------------------
    parity = parity_phase(dev)
    torch.cuda.empty_cache()

    # ---- 25. timing --------------------------------------------------------------------------------
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

    def bmm_ms(pairs) -> float:
        """Median ms of the batched torch.bmm calls of ``pairs`` (A [B, M, K], W [B, K, N], bf16
        out), back to back: the decode's products alone on cuBLAS, a reading beside the kernels
        (the port never calls it)."""
        fn = lambda: [torch.bmm(a, w) for a, w in pairs]  # noqa: E731
        for _ in range(2):
            fn()
        return statistics.median(cuda_ms(fn, 10) for _ in range(4))

    def per_variable(x):  # [N, K] -> [6, N, K], as each variable's product reads it
        return x.expand(n_vars, *x.shape).contiguous()

    wt = {k: getattr(fw, k).to(torch.bfloat16) for k in ("w1", "w1c", "w2f1", "wdf1")}
    rows = lambda k, m: torch.randn(n_vars, m, k, device=dev, dtype=torch.bfloat16)  # noqa: E731
    pe16, cd16 = per_variable(pe.to(torch.bfloat16)), per_variable(cd_pe.to(torch.bfloat16))
    primal_bmm = bmm_ms([(pe16, wt["w1"]), (rows(hid, GRID_POINTS), wt["w2f1"]), (cd16, wt["wdf1"])])
    primal_block = dk._library().dpn_decode_primal_block(int(cd == torch.bfloat16))
    primal_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE, ""),
                                "decode_primal_tc" if cd == torch.bfloat16 else "decode_primal_kernel")
    log(f"[timing] primal decode {cd}: {primal_block} points a block, 256 threads; ptxas {primal_ptxas}; "
        f"its products as 3 batched torch.bmm calls (a reading): {primal_bmm:.4f} ms "
        f"({primal_flops / primal_bmm / 1e9:.2f} TFLOP/s)")
    del pe16, cd16

    fwd_macs = in_ch * hid + 3 * two_f * hid + hid * hid + in_ch * hid + 3 * hid * hid  # per point and variable
    bwd_macs = fwd_macs + (4 * hid * hid + in_ch * hid) + 4 * hid * hid + (in_ch * hid + 3 * two_f * hid)
    v4s_ms, v4s_bmm = {}, {}
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
        # the products of each kernel as batched bf16 torch.bmm calls (a reading): the forward's
        # layer 1, the three tangent directions, [T(p); t_k] . w2f1, cd . wdf1; the backward's the
        # same plus g W^T for the four row sets and the point contractions (gw2f1 over 4 n points,
        # gwdf1, gw1g, gw1t)
        if n in (20480, 4096):
            pe16 = per_variable(pe_cm.to(torch.bfloat16))
            tin16 = pe16.reshape(n_vars, n, 3, two_f).permute(0, 2, 1, 3).reshape(3 * n_vars, n, two_f)
            w16 = {k: getattr(fw6, k).to(torch.bfloat16) for k in ("w1g", "w1t", "w2f1", "wdf1")}
            fwd_pairs = [(pe16, w16["w1g"].reshape(n_vars, in_ch, hid)),
                         (tin16.contiguous(), w16["w1t"].reshape(3 * n_vars, two_f, hid)),
                         (rows(hid, 4 * n), w16["w2f1"]), (per_variable(cd_pe6.to(torch.bfloat16)), w16["wdf1"])]
            cols = lambda k, m: torch.randn(n_vars, k, m, device=dev, dtype=torch.bfloat16)  # noqa: E731
            bwd_pairs = fwd_pairs + [(rows(hid, 4 * n), w16["w2f1"].transpose(1, 2)),
                                     (cols(hid, 4 * n), rows(hid, 4 * n)), (cols(in_ch, n), rows(hid, n)),
                                     (cols(in_ch, n), rows(hid, n)),
                                     (torch.randn(3 * n_vars, two_f, n, device=dev, dtype=torch.bfloat16),
                                      torch.randn(3 * n_vars, n, hid, device=dev, dtype=torch.bfloat16))]
            v4s_bmm[n] = (bmm_ms(fwd_pairs), bmm_ms(bwd_pairs))
            log(f"[timing] v4s at N={n} {cd}: the forward's products as 4 batched torch.bmm calls (a reading): "
                f"{v4s_bmm[n][0]:.4f} ms ({2e-9 * n_vars * fwd_macs * n / v4s_bmm[n][0]:.2f} TFLOP/s); the "
                f"backward's as 9: {v4s_bmm[n][1]:.4f} ms ({2e-9 * n_vars * bwd_macs * n / v4s_bmm[n][1]:.2f} TFLOP/s)")
            del pe16, tin16, w16, fwd_pairs, bwd_pairs
        v4s_ms[n] = dict(fwd=f_ms, fwd_plain=fp_ms, bwd=b_ms, bwd_plain=bp_ms, fwd_bound=f_bound, bwd_bound=b_bound)
        log(f"[timing] v4s at N={n} {cd}: forward kernel {f_ms:.4f} ms ({2e-9 * n_vars * fwd_macs * n / f_ms:.2f} "
            f"TFLOP/s), plain {fp_ms:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]}); backward kernel "
            f"{b_ms:.4f} ms ({2e-9 * n_vars * bwd_macs * n / b_ms:.2f} TFLOP/s), plain {bp_ms:.4f} ms, bound "
            f"{b_bound[0]:.4f} ms ({b_bound[1]}); runs fwd {[round(t, 3) for t in f_times['kernel']]} "
            f"bwd {[round(t, 3) for t in b_times['kernel']]}")
    del fw6, pe_cm, cd_pe6, ref6, g_p, g_t
    # points a block, registers and spills, and the backward's atomic adds into global memory
    jvp_lib, bwd_lib = dk._jvp_library(dk.SOURCE_JVP_V4S), dk._jvp_library(dk.SOURCE_BWD_V4S)
    bwd_lib.dpn_decode_bwd_v4s_atomic_bytes.restype = ctypes.c_int64
    is_bf16 = int(cd == torch.bfloat16)
    v4s_block = (jvp_lib.dpn_decode_jvp_v4s_block(), bwd_lib.dpn_decode_bwd_v4s_block(is_bf16))
    v4s_ptxas = (kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V4S, ""),
                              "decode_jvp_v4s_tc" if is_bf16 else "decode_jvp_v4s_kernel"),
                 kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_BWD_V4S, ""),
                              "decode_bwd_v4s_tc" if is_bf16 else "decode_bwd_v4s_kernel"))
    # the earlier CUDA-core body added each 64-point block's gw2f1 partial once for each of the
    # four row-set pairs: 4 HID^2 + 3 in_ch HID floats, and 4 HID + in_ch of column sums
    atomic_before = 4 * (4 * hid * hid + 3 * in_ch * hid + 4 * hid + in_ch)
    v4s_atomic = {}
    for n in (20480, 4096):
        blocks = -(-n // v4s_block[1]) * n_vars
        v4s_atomic[n] = blocks * bwd_lib.dpn_decode_bwd_v4s_atomic_bytes(is_bf16, in_ch)
        log(f"[backward traffic] v4s / v6 backward at N={n} {cd}: {blocks} blocks add "
            f"{v4s_atomic[n] / 1e9:.3f} GB into the outputs with atomic adds (the earlier CUDA-core body: "
            f"{-(-n // 64) * n_vars * atomic_before / 1e9:.3f} GB)")
    # what the partials' atomic adds cost: the backward against its variant without them, at the
    # step's larger launch, in turns (tree, variant, tree)
    fw6, pe_cm, cd_pe6, _ = v4s_inputs(20480, cd)
    g_p, g_t = cotangents(20480, seed=3)
    bwd_fn = lambda: dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd_pe6, g_p, g_t, cd)  # noqa: E731
    variant = without_partial_atomics(cuda_build, dk.SOURCE_BWD_V4S)
    load_library = cuda_build.load_library
    atomic_ms = []
    for skip in (False, True, False):
        dk._jvp_library.cache_clear()
        cuda_build.load_library = (lambda source: variant if source == dk.SOURCE_BWD_V4S
                                   else load_library(source)) if skip else load_library
        try:
            bwd_fn()
            atomic_ms.append(statistics.median(cuda_ms(bwd_fn, 5) for _ in range(4)))
        finally:
            cuda_build.load_library = load_library
            dk._jvp_library.cache_clear()
    log(f"[backward traffic] v4s backward at N=20480 {cd}: {atomic_ms[0]:.4f} / {atomic_ms[2]:.4f} ms, and "
        f"{atomic_ms[1]:.4f} ms with the partials' atomic adds skipped (a variant built for this reading): "
        f"the adds cost {(atomic_ms[0] + atomic_ms[2]) / 2 - atomic_ms[1]:.4f} ms")
    del fw6, pe_cm, cd_pe6, g_p, g_t
    log(f"[timing] v4s forward {cd}: {v4s_block[0]} points and one variable a block, 256 threads; ptxas "
        f"{v4s_ptxas[0]}")
    log(f"[timing] v4s backward {cd}: {v4s_block[1]} points and one variable a block, 256 threads; ptxas "
        f"{v4s_ptxas[1]}")

    # the v4 pair in both layouts, at one evaluation frame and at the step's larger launch;
    # the same operations per point as v4s (two_f = in_ch / 3 lanes per tangent direction)
    v4_ms, v4_bwd_bmm, v4_fwd_bmm = {}, {}, {}
    frame = frame_inputs(6.5, cd, with_tangents=True)
    for n in (GRID_POINTS, 20480, 4096):
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
        # the forward's products as batched bf16 torch.bmm calls: layer 1, the three tangent
        # directions, [T(p); t_1; t_2; t_3] . w2f1 as one product, cd . wdf1
        _, pe_, dpe_, cd_ = ins
        dpe16 = dpe_.to(torch.bfloat16).expand(n_vars, *dpe_.shape).reshape(3 * n_vars, n, two_f)
        fwd_pairs = [(per_variable(pe_.to(torch.bfloat16)), wt["w1"]), (dpe16, wt["w1c"].reshape(3 * n_vars, two_f, hid)),
                     (rows(hid, 4 * n), wt["w2f1"]), (per_variable(cd_.to(torch.bfloat16)), wt["wdf1"])]
        v4_bmm = v4_fwd_bmm[n] = bmm_ms(fwd_pairs)
        log(f"[timing] v4 forward at N={n} {cd}: its products as 4 batched torch.bmm calls (a reading): "
            f"{v4_bmm:.4f} ms ({2e-9 * n_vars * fwd_macs * n / v4_bmm:.2f} TFLOP/s)")
        if n != GRID_POINTS:
            # the backward's products as batched bf16 torch.bmm calls: the forward's, g W^T for the four
            # row sets, and the point contractions (gw2f1 over 4 n points, gwdf1, gw1, gw1c from dpe)
            cols = lambda k, m: torch.randn(n_vars, k, m, device=dev, dtype=torch.bfloat16)  # noqa: E731
            v4_bwd_bmm[n] = bmm_ms(fwd_pairs + [
                (rows(hid, 4 * n), wt["w2f1"].transpose(1, 2)), (cols(hid, 4 * n), rows(hid, 4 * n)),
                (cols(in_ch, n), rows(hid, n)), (cols(in_ch, n), rows(hid, n)),
                (dpe16.transpose(1, 2), torch.randn(3 * n_vars, n, hid, device=dev, dtype=torch.bfloat16))])
            log(f"[timing] v4 backward at N={n} {cd}: its products as 9 batched torch.bmm calls (a reading): "
                f"{v4_bwd_bmm[n]:.4f} ms ({2e-9 * n_vars * bwd_macs * n / v4_bwd_bmm[n]:.2f} TFLOP/s)")
        del pe_, dpe_, cd_, dpe16, fwd_pairs
    v4_block = dk._jvp_library(dk.SOURCE_JVP_V4).dpn_decode_jvp_v4_block()
    v4_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V4, ""), "decode_jvp_v4_tcILi0E"
                            if cd == torch.bfloat16 else "decode_jvp_v4_kernelIfLi0E")
    log(f"[timing] v4 forward {cd}: {v4_block} points and one variable a block, 256 threads; ptxas {v4_ptxas}")
    # the v4 backward's points a block, registers and spills, and atomic adds into global memory
    bwd4_lib = dk._jvp_library(dk.SOURCE_BWD_V4)
    bwd4_lib.dpn_decode_bwd_v4_atomic_bytes.restype = ctypes.c_int64
    v4_bwd_block = bwd4_lib.dpn_decode_bwd_v4_block(is_bf16)
    v4_bwd_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_BWD_V4, ""),
                                "decode_bwd_v4_tc" if is_bf16 else "decode_bwd_v4_kernelIfLi4E")
    v4_atomic = {n: -(-n // v4_bwd_block) * n_vars * bwd4_lib.dpn_decode_bwd_v4_atomic_bytes(is_bf16, in_ch)
                 for n in (20480, 4096)}
    log(f"[timing] v4 backward {cd}: {v4_bwd_block} points and one variable a block, 256 threads; ptxas "
        f"{v4_bwd_ptxas}")
    for n, nbytes in v4_atomic.items():
        log(f"[backward traffic] v4 / v4t backward at N={n} {cd}: {-(-n // v4_bwd_block) * n_vars} blocks add "
            f"{nbytes / 1e9:.3f} GB into the outputs with atomic adds")
    del frame, ins, ref_t, ref_n, g_p, g_t, gp, gt, ref, wt

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

    # the four decode variants at their paths' sizes: v2 at the step's larger launch, v3, v4pe
    # and v5 at one frame.  v2 and v3 compute the uncollapsed decode (933,888 multiply-adds per
    # point and variable), v4pe and v5 the collapsed one (fwd_macs); v3 and v4pe read raw
    # coordinates and conditioning values, the others the prepared PE inputs
    model.eval()
    v2_macs = in_ch * hid + 3 * two_f * hid + 4 * hid * hid + in_ch * hid + 4 * hid * hid + 4 * hid * hid
    variant_ms = {}

    def time_variant(name, n, kernel_fn, plain_fn, macs, inputs, weights):
        k_ms_, p_ms_, times_ = alternating_ms(kernel_fn, plain_fn, 3)
        v_bound = bound(2.0 * n_vars * macs * n, tensor_bytes(*inputs, *weights) + 4 * (n_vars * n + 3 * n_vars * n))
        variant_ms[name] = dict(ms=k_ms_, plain=p_ms_, bound=v_bound, points=n)
        log(f"[timing] {name} at N={n} {cd}: kernel {k_ms_:.4f} ms ({2e-9 * n_vars * macs * n / k_ms_:.2f} TFLOP/s), "
            f"plain {p_ms_:.4f} ms, bound {v_bound[0]:.4f} ms ({v_bound[1]}); runs kernel "
            f"{[round(t, 3) for t in times_['kernel']]} plain {[round(t, 3) for t in times_['plain']]}")

    w2_, pe, dpe, cd_pe, ref = v2_inputs(V2_SIZES[0], cd)
    time_variant("fused_decode_jvp", V2_SIZES[0], lambda: dk.fused_decode_jvp(w2_, pe, dpe, cd_pe, ref, cd),
                 lambda: dk.decode_jvp_v2_ref(w2_, pe, dpe, cd_pe, ref, cd), v2_macs, (pe, dpe, cd_pe, ref),
                 dk._v2_weights(w2_, cd).values())
    # the v2 kernel's points a block, registers and spills, and its products as batched bf16 torch.bmm
    # calls: layer 1, the three tangent directions, w2, f1 and f2 over the four row sets, cd . wd
    n = V2_SIZES[0]
    w16 = {k: getattr(w2_, k).to(torch.bfloat16) for k in ("w1", "w2", "wd", "f1", "f2")}
    v2_bmm = bmm_ms([(per_variable(pe.to(torch.bfloat16)), w16["w1"]),
                     (dpe.to(torch.bfloat16).expand(n_vars, *dpe.shape).reshape(3 * n_vars, n, two_f),
                      dk.slice_tangent_weights(w16["w1"]).reshape(3 * n_vars, two_f, hid)),
                     (rows(hid, 4 * n), w16["w2"]), (per_variable(cd_pe.to(torch.bfloat16)), w16["wd"]),
                     (rows(hid, 4 * n), w16["f1"]), (rows(hid, 4 * n), w16["f2"])])
    v2_block = dk._jvp_library(dk.SOURCE_JVP_V2).dpn_decode_jvp_v2_block()
    v2_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V2, ""),
                            "decode_jvp_v2_tcILb0E" if is_bf16 else "decode_jvp_v2_kernelIfLb0E")
    log(f"[timing] fused_decode_jvp (v2) {cd}: {v2_block} points and one variable a block, 256 threads; ptxas "
        f"{v2_ptxas}; its products as 6 batched torch.bmm calls at N={n} (a reading): {v2_bmm:.4f} ms "
        f"({2e-9 * n_vars * v2_macs * n / v2_bmm:.2f} TFLOP/s)")
    del w16
    w3, coords, nwp, tokens_f, fh_norm_f = frame_points(6.5)
    spec = dcfg.coord_spec
    time_variant("fused_decode_jvp_v3", GRID_POINTS, lambda: dk.fused_decode_jvp_v3(w3, coords, nwp, spec, cd),
                 lambda: dk.decode_jvp_v3_ref(w3, coords, nwp, spec, cd), v2_macs, (coords, nwp),
                 dk._v2_weights(w3, cd).values())
    # v3's points a block, registers and spills, and its products (v2's, on the frame's points) as
    # batched bf16 torch.bmm calls
    w16 = {k: getattr(w3, k).to(torch.bfloat16) for k in ("w1", "w2", "wd", "f1", "f2")}
    n = GRID_POINTS
    v3_bmm = bmm_ms([(rows(in_ch, n), w16["w1"]),
                     (torch.randn(3 * n_vars, n, two_f, device=dev, dtype=torch.bfloat16),
                      w16["w1"].reshape(3 * n_vars, two_f, hid)),
                     (rows(hid, 4 * n), w16["w2"]), (rows(in_ch, n), w16["wd"]),
                     (rows(hid, 4 * n), w16["f1"]), (rows(hid, 4 * n), w16["f2"])])
    v3_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V2, ""),
                            "decode_jvp_v2_tcILb1E" if is_bf16 else "decode_jvp_v2_kernelIfLb1E")
    log(f"[timing] fused_decode_jvp_v3 {cd}: {v2_block} points and one variable a block, 256 threads; ptxas "
        f"{v3_ptxas}; its products as 6 batched torch.bmm calls at N={n} (a reading): {v3_bmm:.4f} ms "
        f"({2e-9 * n_vars * v2_macs * n / v3_bmm:.2f} TFLOP/s)")
    del w16
    fw, pe, dpe, cd_pe, _ = frame_inputs(6.5, cd, with_tangents=True)
    fused_weights = dk._fused_weights(fw, dict(w1=fw.w1), cd).values()
    time_variant("fused_decode_jvp_v4pe", GRID_POINTS, lambda: dk.fused_decode_jvp_v4pe(fw, coords, nwp, spec, cd),
                 lambda: dk.decode_jvp_v4pe_ref(fw, coords, nwp, spec, cd), fwd_macs, (coords, nwp), fused_weights)
    # v4pe's points a block, registers and spills; its products are the v4 forward's (the reading above)
    v4pe_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V4, ""),
                              "decode_jvp_v4_tcILi2E" if is_bf16 else "decode_jvp_v4_kernelIfLi2E")
    log(f"[timing] fused_decode_jvp_v4pe {cd}: {v4_block} points and one variable a block, 256 threads; ptxas "
        f"{v4pe_ptxas}; its products (the v4 forward's) as 4 batched torch.bmm calls at N={GRID_POINTS} (a "
        f"reading): {v4_fwd_bmm[GRID_POINTS]:.4f} ms ({2e-9 * n_vars * fwd_macs * GRID_POINTS / v4_fwd_bmm[GRID_POINTS]:.2f} "
        "TFLOP/s)")
    # one frame through fused_kernel_fields with and without in_kernel_pe: the v4pe kernel on raw
    # coordinates against the prepared PE and the v4 kernel; CUDA events and host clock
    fh_f = torch.tensor([fh_norm_f], device=dev)

    def kernel_fields(pe_in_kernel):
        return lambda: engine.fused_kernel_fields(model, tokens_f, coords, nwp, fh_f, spec, dcfg.obs_specs, version=4,
                                                  in_kernel_pe=pe_in_kernel, raw_tangents=True)

    with torch.no_grad():
        route_ms = alternating_ms(kernel_fields(True), kernel_fields(False), 5)
        route_host = {k: statistics.median(host_ms(kernel_fields(k)) for _ in range(5)) for k in (True, False)}
    log(f"[timing] one frame (N={GRID_POINTS}) through fused_kernel_fields {cd}: in_kernel_pe=True {route_ms[0]:.4f} "
        f"ms, in_kernel_pe=False {route_ms[1]:.4f} ms by CUDA events; {route_host[True]:.3f} and "
        f"{route_host[False]:.3f} ms by host clock around a synchronize")
    time_variant("fused_decode_jvp_v5", GRID_POINTS, lambda: dk.fused_decode_jvp_v5(fw, pe, dpe, cd_pe, nwp, cd),
                 lambda: dk.decode_jvp_v5_ref(fw, pe, dpe, cd_pe, nwp, cd), fwd_macs, (pe, dpe, cd_pe, nwp),
                 dk._fused_weights(fw, dict(w1=fw.w1, w1c=fw.w1c), cd).values())
    # v5's points a block, registers and spills; its products are the v4 forward's (the reading above)
    v5_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(dk.SOURCE_JVP_V4, ""),
                            "decode_jvp_v4_tcILi1E" if is_bf16 else "decode_jvp_v4_kernelIfLi1E")
    log(f"[timing] fused_decode_jvp_v5 {cd}: {v4_block} points and one variable a block, 256 threads; ptxas "
        f"{v5_ptxas}; its products (the v4 forward's) as 4 batched torch.bmm calls at N={GRID_POINTS} (a "
        f"reading): {v4_fwd_bmm[GRID_POINTS]:.4f} ms")
    del w2_, pe, dpe, cd_pe, ref, w3, coords, nwp, fw, fused_weights, tokens_f
    model.train()
    torch.cuda.empty_cache()

    # the residual-sum kernels at the entry points' size: the forward's operations plus the
    # assembly (about 150 float operations per point), the point inputs once and 24 bytes out
    model.eval()
    ASSEMBLY_FLOPS = 150.0
    resid_ms = {}
    coords, nwp, cor = window_points(RESIDUAL_MAIN_N, seed=5)
    # points a block, ptxas, the scratch of a launch, and its products as batched bf16 torch.bmm
    # calls (a reading, the same for v4 and v6: the decode's, as the v4 forward's four)
    resid_block = rk._library().dpn_residual_sums_block(int(cd == torch.bfloat16))
    resid_ptxas = kernel_ptxas(cuda_build.BUILD_LOGS.get(rk.SOURCE, ""),
                               "residual_sums_tc" if cd == torch.bfloat16 else "residual_sums_f32")
    resid_scratch = rk.scratch_bytes(RESIDUAL_MAIN_N, cd)
    n_ = RESIDUAL_MAIN_N
    w16 = {k: getattr(residual_inputs(4, coords, nwp, cd)[0], k).to(torch.bfloat16) for k in ("w1", "w1c", "w2f1", "wdf1")}
    resid_bmm = bmm_ms([(rows(in_ch, n_), w16["w1"]),
                        (torch.randn(3 * n_vars, n_, two_f, device=dev, dtype=torch.bfloat16),
                         w16["w1c"].reshape(3 * n_vars, two_f, hid)),
                        (rows(hid, 4 * n_), w16["w2f1"]), (rows(in_ch, n_), w16["wdf1"])])
    del w16
    log(f"[timing] residual sums {cd}: {resid_block} points a block, 256 threads, grid [n / {resid_block}"
        f"{', 6' if cd == torch.bfloat16 else ''}]; ptxas {resid_ptxas}; scratch {resid_scratch} bytes at "
        f"N={n_}; the decode's products as 4 batched torch.bmm calls (a reading): {resid_bmm:.4f} ms "
        f"({2e-9 * n_vars * fwd_macs * n_ / resid_bmm:.2f} TFLOP/s)")
    for version, (kernel_fn, plain_fn, *_) in residual_fns.items():
        ins = residual_inputs(version, coords, nwp, cd)
        k_ms_, p_ms_, times_ = alternating_ms(
            lambda: kernel_fn(*ins, cor, scfg.obs_specs, compute_dtype=cd),
            lambda: plain_fn(*ins, cor, scfg.obs_specs, compute_dtype=cd), 3)
        flops = (2.0 * n_vars * fwd_macs + ASSEMBLY_FLOPS) * RESIDUAL_MAIN_N
        r_bound = bound(flops, tensor_bytes(*ins[1:], cor, *(w.to(cd) if w.ndim >= 3 else w for w in ins[0])) + 24)
        resid_ms[version] = dict(ms=k_ms_, plain=p_ms_, bound=r_bound, bmm=resid_bmm)
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
    step_fns["kernel v2"] = ts.make_train_step(ts.step_config_from_cfg(cfg, kernel_version=2))
    whole = {"pde kernel": whole_step("kernel", True), "pde kernel v4": whole_step("kernel v4", True),
             "pde kernel v4 [N, 6]": whole_step("kernel v4 [N, 6]", True),
             "pde kernel v6": whole_step("kernel v6", True), "pde kernel v2": whole_step("kernel v2", True),
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
                    if version in (2, 6):  # [N, 6] only
                        box[key] = engine.fused_kernel_fields(
                            model, box["tokens"], coords, pts.nwp[0], box["fh"], scfg_.coord_spec,
                            scfg_.obs_specs, trainable=True, version=version, raw_tangents=True)
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
                if version not in (2, 6):
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
            ("pde kernel v6", "kernel", True, 6), ("pde kernel v2", "kernel", True, 2), ("pde jvp", "jvp", True, 7),
            ("data-only", "kernel", False, 7)):
        runs = [split_step(engine_name, with_pde, version) for _ in range(4)][1:]
        parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        log(f"[timing] {label} step split (median of 3, host clock, a synchronize after each part): " +
            ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()) + f"; sum {sum(parts.values()):.3f} ms")
    log(f"[timing] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    enc_timing = attention_and_encoder_timing(dev, cd, model, field, window.forecast_h / dcfg.forecast_time_period,
                                              enc_stage_builds)

    # ---- 26. profile (only with --profile): the device's busy share and its largest kernels ----
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
                ("pde kernel v2 step", lambda: step_fns["kernel v2"](state, batch, True), whole["pde kernel v2"]),
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
    # steps, the residual entry points, the kernel_version=6 steps, the kernel_version=2 steps,
    # the in_kernel_pe frame, the direct calls of v3 and v5); errors and times at the size of
    # the path's larger launch.
    main_n = 20480  # the larger of the two launches of a PDE step
    t = v4s_ms[main_n]
    csrc = "deepphysinet_tpu_torch/csrc/"
    jax_file = "deepphysinet_tpu/ops/decode_kernel.py"
    # the decode kernels whose bf16 products run on the tensor cores
    tc_products = "tensor cores (mma.sync)" if cd == torch.bfloat16 else "CUDA cores (FMA)"

    def v4s_extra(which, times):
        """The v4s / v6 rows' readings beside the contract's keys: the products, points a block,
        ptxas, the time at the step's smaller launch, the products as batched torch.bmm calls and,
        for the backward, the atomic bytes a launch."""
        i = 0 if which == "fwd" else 1
        extra = {"products": tc_products, "points_a_block": v4s_block[i], "ptxas": v4s_ptxas[i],
                 "ms_4096": times[4096][which], "bound_ms_4096": times[4096][which + "_bound"][0],
                 "bmm_ms": v4s_bmm[main_n][i], "bmm_ms_4096": v4s_bmm[4096][i]}
        if which == "bwd":
            extra.update(atomic_bytes=v4s_atomic[main_n], atomic_bytes_4096=v4s_atomic[4096],
                         ms_without_partial_atomics=atomic_ms[1])
        return extra

    def v4_entry(name, source, replaces, t_layout, n, which, errs_, rels_):
        tm = v4_ms[(t_layout, n)]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": f"{jax_file}:{replaces}",
                "launches": eval_launches[name] + train4_launches[name],
                "launches_eval": eval_launches[name], "launches_train": train4_launches[name],
                "max_abs_err": errs_[(t_layout, cd, n)], "max_rel_err": rels_[(t_layout, cd, n)], "points": n,
                "ms": tm[which], "plain_ms": tm[which + "_plain"], "bound_ms": tm[which + "_bound"][0],
                "bound_by": tm[which + "_bound"][1], "library_ms": None}

    def v4_bwd_extra(t_layout):
        """The v4 backward rows' readings beside the contract's keys, as the v4s rows have them."""
        tm = v4_ms[(t_layout, 4096)]
        return {"products": tc_products, "points_a_block": v4_bwd_block, "ptxas": v4_bwd_ptxas,
                "ms_4096": tm["bwd"], "bound_ms_4096": tm["bwd_bound"][0], "bmm_ms": v4_bwd_bmm[main_n],
                "bmm_ms_4096": v4_bwd_bmm[4096], "atomic_bytes": v4_atomic[main_n], "atomic_bytes_4096": v4_atomic[4096]}

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
                "library_ms": None, "products": tc_products, "points_a_block": resid_block, "ptxas": resid_ptxas,
                "bmm_ms": tm["bmm"], "scratch_bytes": resid_scratch}

    def variant_entry(name, source, replaces, launches, **split):
        tm = variant_ms[name]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": f"{jax_file}:{replaces}",
                "launches": launches, **split, "max_abs_err": variant_err[(name, cd, tm["points"])],
                "max_rel_err": variant_rel[(name, cd, tm["points"])], "points": tm["points"], "ms": tm["ms"],
                "plain_ms": tm["plain"], "bound_ms": tm["bound"][0], "bound_by": tm["bound"][1], "library_ms": None}

    def attention_entry(name, replaces, launches):
        tm = enc_timing[(name, 287)]
        longer = [{"tokens": n, "ms": enc_timing[(nm, n)]["ms"], "device_ms": enc_timing[(nm, n)]["device"],
                   "plain_ms": enc_timing[(nm, n)]["plain"], "library_ms": enc_timing[(nm, n)]["library"],
                   "library_device_ms": enc_timing[(nm, n)]["library_device"],
                   "bound_ms": enc_timing[(nm, n)]["bound"][0], "bound_terms_ms": enc_timing[(nm, n)]["bound_terms"]}
                  for nm, n in ATTN_TIMED if nm == name and n != 287]
        return {"name": name, "route": "cuda", "source": csrc + "attention.cu",
                "replaces": f"deepphysinet_tpu/ops/attention.py:{replaces}", "launches": launches,
                "max_abs_err": attn_errs[(name, cd, 287)], "tokens": 287, "ms": tm["ms"], "device_ms": tm["device"],
                "plain_ms": tm["plain"], "bound_ms": tm["bound"][0], "bound_by": tm["bound"][1],
                "bound_terms_ms": tm["bound_terms"], "library_ms": tm["library"],
                "library_device_ms": tm["library_device"], "longer": longer}

    print(json.dumps({"kernels": [
        {"name": "decode_primal_v4t", "route": "cuda", "source": csrc + "decode_primal.cu",
         "replaces": f"{jax_file}:956",
         "launches": primal_launches, "launches_eval": eval_launches["decode_primal_v4t"],
         "launches_disk": disk_launches, "launches_test": trainer["test_launches"],
         "launches_tools": tools["launches"].get("decode_primal_v4t", 0),
         "launches_etl": etl["infer_launches"] + etl["test_launches"],
         "launches_options": options["launches"]["decode_primal_v4t"],
         "launches_parity": sum(n["decode_primal_v4t"] for n in parity["launches"].values()),
         "max_abs_err": errs[(cd, GRID_POINTS)], "max_rel_err": rel_errs[(cd, GRID_POINTS)],
         "points": GRID_POINTS,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": primal_bound[0], "bound_by": primal_bound[1],
         "library_ms": None, "products": tc_products},
        {"name": "fused_decode_jvp_v4s", "route": "cuda", "source": csrc + "decode_jvp_v4s.cu",
         "replaces": f"{jax_file}:2358",
         "launches": fwd_launches, "launches_trainer": trainer["counts"]["fused_decode_jvp_v4s"],
         "launches_device_trainer": device_trainer["counts"]["fused_decode_jvp_v4s"],
         "launches_etl": etl["counts"]["fused_decode_jvp_v4s"],
         "launches_options": options["launches"]["fused_decode_jvp_v4s"],
         "launches_dist": dist["counts"]["fused_decode_jvp_v4s"],
         "launches_parity": sum(n["fused_decode_jvp_v4s"] for n in parity["launches"].values()),
         "max_abs_err": fwd_err[(cd, main_n)],
         "max_rel_err": fwd_rel[(cd, main_n)], "points": main_n,
         "ms": t["fwd"], "plain_ms": t["fwd_plain"], "bound_ms": t["fwd_bound"][0],
         "bound_by": t["fwd_bound"][1], "library_ms": None, **v4s_extra("fwd", v4s_ms)},
        {"name": "decode_bwd_kernel_v4s", "route": "cuda", "source": csrc + "decode_bwd_v4s.cu",
         "replaces": f"{jax_file}:2508",
         "launches": bwd_launches, "launches_trainer": trainer["counts"]["decode_bwd_kernel_v4s"],
         "launches_device_trainer": device_trainer["counts"]["decode_bwd_kernel_v4s"],
         "launches_etl": etl["counts"]["decode_bwd_kernel_v4s"],
         "launches_options": options["launches"]["decode_bwd_kernel_v4s"],
         "launches_dist": dist["counts"]["decode_bwd_kernel_v4s"],
         "launches_parity": sum(n["decode_bwd_kernel_v4s"] for n in parity["launches"].values()),
         "max_abs_err": bwd_err[(cd, main_n)],
         "max_rel_err": bwd_rel[(cd, main_n)], "points": main_n,
         "ms": t["bwd"], "plain_ms": t["bwd_plain"], "bound_ms": t["bwd_bound"][0],
         "bound_by": t["bwd_bound"][1], "library_ms": None, **v4s_extra("bwd", v4s_ms)},
        # the [N, 6] and [6, N] forms share one source; the sweeps decode one frame per launch
        # launches_tools: the [N, 6] form runs under evaluate --residuals --save_maps, which needs matplotlib
        {**v4_entry("fused_decode_jvp_v4", "decode_jvp_v4.cu", 781, False, GRID_POINTS, "fwd", v4_fwd_err,
                    v4_fwd_rel), "products": tc_products,
         "launches_tools": tools["launches"].get("fused_decode_jvp_v4", 0)},
        {**v4_entry("fused_decode_jvp_v4t", "decode_jvp_v4.cu", 855, True, GRID_POINTS, "fwd", v4_fwd_err,
                    v4_fwd_rel), "products": tc_products,
         "launches_tools": tools["launches"].get("fused_decode_jvp_v4t", 0)},
        {**v4_entry("decode_bwd_kernel_v4", "decode_bwd_v4.cu", 1562, False, main_n, "bwd", v4_bwd_err, v4_bwd_rel),
         **v4_bwd_extra(False)},
        {**v4_entry("decode_bwd_kernel_v4t", "decode_bwd_v4.cu", 1642, True, main_n, "bwd", v4_bwd_err, v4_bwd_rel),
         **v4_bwd_extra(True)},
        # the v6 pair shares its sources with the v4s pair (another operand layout)
        {**v6_entry("fused_decode_jvp_v6", "decode_jvp_v4s.cu", 1978, "fwd", v6_fwd_err, v6_fwd_rel),
         **v4s_extra("fwd", v6_ms)},
        {**v6_entry("decode_bwd_kernel_v6", "decode_bwd_v4s.cu", 2115, "bwd", v6_bwd_err, v6_bwd_rel),
         **v4s_extra("bwd", v6_ms)},
        residual_entry("fused_residual_sums_v6", 6, 127),
        residual_entry("fused_residual_sums_v4", 4, 48),
        # the attention kernels at the encoder's 287 tokens: the paths' shape
        {**attention_entry("attention_tile", 48, attn_launches["attention_tile"]),
         "launches_options": options["launches"]["attention_tile"]},
        attention_entry("attention_flash", 95, attn_launches["attention_flash"]),
        {"name": "fused_encoder_forward", "route": "cuda", "source": csrc + "encoder.cu",
         "replaces": "deepphysinet_tpu/ops/encoder_kernel.py:132", "launches": enc["launches"],
         "max_abs_err": enc["errs"][cd], "tokens": 287, "ms": enc_timing["encoder"]["ms"],
         "plain_ms": enc_timing["encoder"]["plain"], "bound_ms": enc_timing["encoder"]["bound"][0],
         "bound_by": enc_timing["encoder"]["bound"][1], "library_ms": None,
         "products": tc_products, "device_ms": enc_timing["encoder"]["device_ms"],
         "stage_ms": enc_timing["encoder"]["stage_ms"]},
        # the four decode variants: v2 on its training and residual paths, v4pe on the in_kernel_pe
        # route, v3 and v5 on their own entry points (one direct call each)
        {**variant_entry("fused_decode_jvp", "decode_jvp_v2.cu", 270,
                         train2_launches["fused_decode_jvp"] + resid_launches["fused_decode_jvp"],
                         launches_train=train2_launches["fused_decode_jvp"],
                         launches_eval=resid_launches["fused_decode_jvp"]),
         "products": tc_products, "points_a_block": v2_block, "ptxas": v2_ptxas, "bmm_ms": v2_bmm},
        {**variant_entry("fused_decode_jvp_v4pe", "decode_jvp_v4.cu", 1386, pe_launches["fused_decode_jvp_v4pe"]),
         "products": tc_products, "points_a_block": v4_block, "ptxas": v4pe_ptxas,
         "bmm_ms": v4_fwd_bmm[GRID_POINTS]},
        {**variant_entry("fused_decode_jvp_v3", "decode_jvp_v2.cu", 459, direct_launches["fused_decode_jvp_v3"]),
         "products": tc_products, "points_a_block": v2_block, "ptxas": v3_ptxas, "bmm_ms": v3_bmm},
        {**variant_entry("fused_decode_jvp_v5", "decode_jvp_v4.cu", 1226, direct_launches["fused_decode_jvp_v5"]),
         "products": tc_products, "points_a_block": v4_block, "ptxas": v5_ptxas,
         "bmm_ms": v4_fwd_bmm[GRID_POINTS]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist_child"]:  # one rank of phase 24 (a), under torch.distributed.run
        sys.exit(dist_child(sys.argv[2:]))
    sys.exit(main())
