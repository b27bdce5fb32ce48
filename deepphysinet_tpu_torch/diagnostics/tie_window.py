"""How near a bf16 rounding tie the tensor-core decodes' sums must lie to be summed again.

The bf16 tensor-core forwards add their products in another order than cuBLAS, whose f32 product
the plain versions use (one FMA a term in k order), so a value near a bf16 rounding tie can round
the other way; the kernels sum it again in cuBLAS's order where it lies within a window of a tie:
``TIE_ULPS`` ulps of the value, or a floor of so many 2^-24 times the largest |value| of the
warp's 32 columns of the row.  This script emulates the kernels' sums on the card (each k16
chunk's 16 exact products rounded once to f32, the chunks added in f32 in k order, as the
kernels' ``warp_mma`` adds z's products; u_k's accumulate inside the tensor cores, which this
models the same way) and, for each value the windows read, prints the elements whose rounding
differs from cuBLAS's, the largest |emulated - cuBLAS| in units of 2^-24 times that largest
value, and, for each floor of ``FLOORS`` such units (0: the ulp window alone), the values the
window flags a block of 64 points and variable and the differing ones it misses:

* the v4 / v4t forward's z (T(p)) and u_k (t_k) on one 145 x 257 frame (``chip_smoke.py``'s
  phase 7; v5's too, the same operands through the same stage 1: v5 differs in r's sum only), and
  the v4s forward's (v6 has the same values in another layout) on the batch's
  20,480 margin points, the windows of ``csrc/decode_jvp_tc.cuh`` (``TIE_ULPS_Z``,
  ``TIE_ULPS_U``, ``TIE_FLOOR_Z``, ``TIE_FLOOR_U``: ``KERNEL_FLOORS``);
* the v2 forward's z (T(p)) and c (T(c)) on the margin points (``csrc/decode_jvp_v2.cu``);
* the v4pe forward's z and u_k, and the v3 forward's c, on the frame's channel-major operands
  (the in-kernel PE rounded to bf16, with the channel-major weights): v4pe takes v4's windows and
  floors, v3 v2's (v3's z is v4pe's, the same operands and weights);
* the backwards' row cotangents g_z = 1[z > 0] (g_rp W^T + 2 go b) and g_tz,k, which
  ``csrc/decode_bwd_tc.cuh`` rounds to bf16 before the point contractions: on phase 7's v4 operands
  (the frame's first points at each of ``chip_smoke.V4_SIZES``, its seeded cotangents, zero near a
  relu kink) and on phases 5's and 10's v4s / v6 margin operands, against the floor of
  ``TIE_FLOOR_G`` (64 columns a row, the epilogue's pass; no ulp window), with how many elements
  cuBLAS's g_r W^T sums otherwise than one FMA a term, and how many stay flipped once the flagged
  ones are summed again in that order, as the kernel's ``fix_g_ties`` does.

First with the seeded flagship weights, then with the weights of each of ``--trainings``
trainings of six steps from them (three data-only, three PDE, as ``chip_smoke.py``'s phase 6
trains them before phase 7 reads the frame): the backward's atomic adds make each training end a
few ulps apart.  Run from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.tie_window --trainings 2
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TIE_ULPS = {"z": 32, "u": 8, "c": 32, "g": 0}  # csrc/decode_jvp_tc.cuh, csrc/decode_jvp_v2.cu; the backward's
# g window (csrc/decode_bwd_tc.cuh) has its floor only
FLOORS = (0, 4, 8, 16, 20, 24, 32)  # in units of 2^-24 times the largest |value| of the warp's 32 columns
KERNEL_FLOORS = {"z": 16, "u": 16, "c": 20, "g": 16}  # TIE_FLOOR_Z, TIE_FLOOR_U of csrc/decode_jvp_tc.cuh; v2 / v3's
# TIE_FLOOR of csrc/decode_jvp_v2.cu for c (z there takes 20, so a count of 0 at 16 holds it too);
# TIE_FLOOR_G of csrc/decode_bwd_tc.cuh for g_z and g_tz,k
EPS = 2.0 ** -24


def emulated(x, y, bf=torch.bfloat16):
    """x @ y as the kernel adds it: each k16 chunk's exact products summed and rounded to f32
    once, the chunks added in f32 in k order."""
    x, y = x.to(bf).double(), y.to(bf).double()
    acc = None
    for c0 in range(0, x.shape[-1], 16):
        d = torch.matmul(x[..., c0:c0 + 16], y[..., c0:c0 + 16, :]).float()
        acc = d if acc is None else acc + d
    return acc


def window_flags(tc, live, ulps, floor, cols=32):
    """The values a kernel's window flags: within ``ulps`` of a bf16 tie, or within ``floor`` x
    2^-24 x the largest |value| of their group of ``cols`` columns of the row (``live``: nonzero)."""
    bits = tc.view(torch.int32)
    low = ((bits & 0xFFFF) - 0x8000).abs()
    ulp = torch.ldexp(torch.ones_like(tc), (torch.frexp(tc.abs())[1] - 24).to(torch.int32))
    rows = tc.abs().reshape(*tc.shape[:-1], -1, cols).amax(-1, keepdim=True)
    m32 = rows.expand(*rows.shape[:-1], cols).reshape(tc.shape)
    return live & ((low <= ulps) | (low.float() * ulp <= floor * EPS * m32))


def window_reading(name, tc, seq, rounds, blocks, ulps, missed, cols=32):
    """One line for the values ``tc`` (emulated) against ``seq`` (cuBLAS); adds each floor's
    missed flips into ``missed``.  A flip with either side at zero (a relu argument on the other
    side of its kink, or an exact cancellation) is no tie: no window flags a zero, and
    ``chip_smoke.py`` leaves the points near a kink out (KINK_EPS); those are counted apart."""
    bf = torch.bfloat16
    differ = rounds(tc).to(bf) != rounds(seq).to(bf)
    at_zero = differ & ((rounds(tc) == 0) | (rounds(seq) == 0))
    differ &= ~at_zero
    bits = tc.view(torch.int32)
    low = ((bits & 0xFFFF) - 0x8000).abs()
    ulp = torch.ldexp(torch.ones_like(tc), (torch.frexp(tc.abs())[1] - 24).to(torch.int32))
    dist = low.float() * ulp
    rows = tc.abs().reshape(*tc.shape[:-1], -1, cols).amax(-1, keepdim=True)
    m32 = rows.expand(*rows.shape[:-1], cols).reshape(tc.shape)
    live = rounds(tc) != 0
    worst = float(((tc - seq).abs() / (EPS * m32.clamp_min(1e-30))).max())
    parts = []
    for g in FLOORS:
        flag = live & ((low <= ulps) | (dist <= g * EPS * m32))
        miss = int((differ & ~flag).sum())
        missed[g] = missed.get(g, 0) + miss
        parts.append(f"{g}: {int(flag.sum()) / blocks:.1f} flagged, {miss} missed")
    print(f"[tie window] {name}: {int(differ.sum())} of {tc.numel()} elements round otherwise than cuBLAS's "
          f"(and {int(at_zero.sum())} with a side at zero); "
          f"|emulated - cuBLAS| at most {worst:.2f} x 2^-24 x the row's largest |value| of its {cols} columns; "
          f"window of {ulps} ulps or a floor of (per block and variable) " + "; ".join(parts), flush=True)


def layer1_reading(label, x, w1, b1, tangents, missed):
    """z = x . w1 + b1 (T(p) = T(relu z)) and u_k = 1[z > 0] (x_k . w1c_k) for (x_k, w1c_k) in
    ``tangents``, emulated against cuBLAS; the mask is cuBLAS's z > 0 for both."""
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    bf = torch.bfloat16
    blocks = w1.shape[0] * x.shape[0] / 64
    z_seq = dot_f32(x, w1, bf) + b1[:, None, :]
    window_reading(f"{label} z (T(p))", emulated(x, w1) + b1[:, None, :], z_seq, torch.relu, blocks,
                   TIE_ULPS["z"], missed["z"])
    mask = (z_seq > 0).float()
    del z_seq
    for k, (xk, wk) in enumerate(tangents):
        window_reading(f"{label} u_{k} (t_{k})", emulated(xk, wk) * mask, dot_f32(xk, wk, bf) * mask,
                       lambda v: v, blocks, TIE_ULPS["u"], missed["u"])
        torch.cuda.empty_cache()


def c_reading(label, w, pe, cd, missed, with_z=True):
    """The v2 chain's z (T(p); with ``with_z``) and c = ((T(p) . w2 + b2) + (cd . wd + bd)) + fh
    (T(c)), emulated against cuBLAS, c from cuBLAS's T(p) as the plain version has it."""
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    bf = torch.bfloat16
    blocks = w.w1.shape[0] * pe.shape[0] / 64
    z_seq = dot_f32(pe, w.w1, bf) + w.b1[:, None, :]
    if with_z:
        window_reading(f"{label} z (T(p))", emulated(pe, w.w1) + w.b1[:, None, :], z_seq, torch.relu, blocks,
                       TIE_ULPS["z"], missed["z"])
    p = torch.relu(z_seq).to(bf).float()  # cuBLAS's T(p): c's inputs as the plain version has them
    del z_seq
    c_tc = ((emulated(p, w.w2) + w.b2[:, None, :]) + (emulated(cd, w.wd) + w.bd[:, None, :])) + w.fh_add[:, None, :]
    c_seq = ((dot_f32(p, w.w2, bf) + w.b2[:, None, :]) + (dot_f32(cd, w.wd, bf) + w.bd[:, None, :])
             + w.fh_add[:, None, :])
    window_reading(f"{label} c (T(c))", c_tc, c_seq, lambda x: x, blocks, TIE_ULPS["c"], missed["c"])


def backward_reading(label, pe, w1, fw, cd_pe, cases, missed):
    """The backward's row cotangents g_z = 1[z > 0] (g_rp W^T + 2 go b) and g_tz,k = 1[z > 0]
    (g_rt,k W^T + 2 gto_k b), which ``csrc/decode_bwd_tc.cuh`` rounds to bf16 in g W^T's epilogue
    before the point contractions gw1 = pe^T g_z and gw1c[k] = tan_k^T g_tz,k: the tensor cores'
    sum (emulated) against cuBLAS's, over the cases (n, g_p, g_t) together, each the first n points
    of ``pe`` [N, in_ch] (layer 1 by ``w1`` [V, in_ch, H]) with its
    seeded cotangents (zero near a relu kink).  Also counts where cuBLAS's g_r W^T differs from one
    FMA a term in k order, the order a recompute near a tie follows.  The windows' columns are the
    64 of one pass of the kernel's epilogue."""
    from deepphysinet_tpu_torch.diagnostics.backward_edges import row_cotangents, sequential
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    bf = torch.bfloat16
    got = {"tc": ([], []), "seq": ([], [])}
    got["fma"] = ([], [])
    fma_differ, elements = [0, 0], [0, 0]
    for n, g_p, g_t in cases:
        args = (pe[:n], w1, fw, cd_pe[:n], g_p, g_t)
        seq = row_cotangents(*args, lambda x, y: dot_f32(x, y, bf))
        fma = row_cotangents(*args, sequential)
        for i in range(2):
            fma_differ[i] += int((seq[i] != fma[i]).sum())
            elements[i] += seq[i].numel()
        for key, vals in (("seq", seq), ("fma", fma), ("tc", row_cotangents(*args, emulated))):
            got[key][0].append(vals[0])
            got[key][1].append(vals[1])
        torch.cuda.empty_cache()
    points = sum(c[0] for c in cases)
    blocks = w1.shape[0] * points / 64
    remain = []
    for i, name in enumerate(("g_z", "g_tz,k")):
        tc, seq, fma = (torch.cat(got[k][i], dim=-2) for k in ("tc", "seq", "fma"))
        window_reading(f"{label} backward {name} ({points} points)", tc, seq, lambda v: v, blocks, TIE_ULPS["g"],
                       missed["g"], cols=64)
        # what the kernel's fix_g_ties leaves: the flagged values summed again one FMA a term
        flag = window_flags(tc, tc != 0, TIE_ULPS["g"], KERNEL_FLOORS["g"], cols=64)
        remain.append(int((torch.where(flag, fma, tc).to(bf) != seq.to(bf)).sum()))
        del tc, seq, fma, flag
    missed["g fixed"][0] = missed["g fixed"].get(0, 0) + sum(remain)
    print(f"[tie window] {label} backward: cuBLAS's g_r W^T differs from one FMA a term in k order at "
          f"{fma_differ[0]} of {elements[0]} g_z and {fma_differ[1]} of {elements[1]} g_tz,k elements; with the "
          f"flagged values (floor {KERNEL_FLOORS['g']}) summed again in that order, as fix_g_ties sums them, "
          f"{remain[0]} g_z and {remain[1]} g_tz,k elements still round otherwise than cuBLAS's", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trainings", type=int, default=2, help="trainings of six steps from the seeded weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tie_window: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the repository's root is on the path under ``python -m``
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf, n = torch.device("cuda"), torch.bfloat16, 20480
    cfg = Config.fromfile(cs.FLAGSHIP_CFG)["config"]
    scfg = ts.step_config_from_cfg(cfg)
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    window = synthetic_window(cfg, seed=0)
    field = torch.from_numpy(window.field[None]).to(dev)
    spec = scfg.coord_spec
    xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
    px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel(), ys.ravel(), np.full(xs.size, 6.5))
    frame = torch.from_numpy(np.stack([px, py, pt], -1)).to(dev), torch.from_numpy(nwp).to(dev)
    fh_frame = window.forecast_h / runner.decode_config_from_cfg(cfg).forecast_time_period
    missed = {"z": {}, "u": {}, "c": {}, "g": {}, "g fixed": {}}
    n_vars = len(runner.decode_config_from_cfg(cfg).obs_specs)

    def cases(sizes, seed_of):  # chip_smoke.py's seeded cotangents of each size, zero near a kink
        from deepphysinet_tpu_torch.diagnostics.backward_edges import cotangents
        return [(n, *cotangents(n, seed_of(n), n_vars, dev)) for n in sizes]

    def zero_near(cs_, fw, pe, w1, cd_pe):
        from deepphysinet_tpu_torch.diagnostics.backward_edges import near_kink
        for n, g_p, g_t in cs_:
            near = near_kink(fw, pe[:n], w1, cd_pe[:n], bf, cs.KINK_EPS)
            g_p[:, near], g_t[:, :, near] = 0.0, 0.0
        return cs_

    def read(label, model):
        with torch.no_grad():
            # the v4 / v4t and v5 forwards on one frame
            tokens = runner._encode(model, field, fh_frame)
            w, pe, dpe, cd_f = engine._kernel_inputs(model, tokens, *frame, torch.tensor([fh_frame], device=dev), spec)
            fw = dk.fuse_decode_weights(w)
            layer1_reading(f"{label}, v4 and v5 frame", pe.to(bf), fw.w1, fw.b1,
                           [(dpe[k].to(bf), fw.w1c[:, k]) for k in range(3)], missed)
            # the v4 / v4t backward on phase 7's operands: the frame's first points, its cotangents
            pe, dpe, cd_f = pe.to(bf), dpe.to(bf), cd_f.to(bf)
            backward_reading(f"{label}, v4 frame", pe, fw.w1, fw, cd_f,
                             zero_near(cases(cs.V4_SIZES, lambda n: n + 1), fw, pe, fw.w1, cd_f), missed)
            del pe, dpe, cd_f, fw
            # the v4pe and v3 forwards on the same frame: the in-kernel PE and the channel-major weights
            in_ch = w.w1.shape[1]
            ch = in_ch // 3
            pe_cm, t_cm, cd_cm = (x.to(bf) for x in dk.pe_front_end(*frame, spec, in_ch))
            w3 = dk._v3_weights(w)
            layer1_reading(f"{label}, v4pe and v3 frame (channel-major)", pe_cm, w3.w1, w3.b1,
                           [(t_cm[k], w3.w1[:, k * ch:(k + 1) * ch]) for k in range(3)], missed)
            c_reading(f"{label}, v3 frame (channel-major)", w3, pe_cm, cd_cm, missed, with_z=False)
            del w, w3, pe_cm, t_cm, cd_cm
            # the v4s forward and the v2 forward on the margin points
            fh = (batch.forecast_h / scfg.forecast_time_period)[:, None]
            tokens = model.encode(batch.field, fh)[0]
            m = batch.margin
            coords = torch.stack([m.x[0, :n], m.y[0, :n], m.t[0, :n]], dim=-1)
            w, pe_cm, cd_m = engine._kernel_inputs_s(model, tokens, coords, m.nwp[0, :n], fh[0], spec)
            fw6 = dk.fuse_v6_from_v4(dk.fuse_decode_weights(w), spec)
            nv, _, ch, hid = fw6.w1t.shape
            pe_cm = pe_cm.to(bf)
            layer1_reading(f"{label}, v4s margin", pe_cm, fw6.w1g.reshape(nv, 3 * ch, hid), fw6.b1,
                           [(pe_cm[:, k * ch:(k + 1) * ch], fw6.w1t[:, k]) for k in range(3)], missed)
            # the v4s and v6 backwards on phases 5's and 10's operands and cotangents
            w1g, cd_m = fw6.w1g.reshape(nv, 3 * ch, hid), cd_m.to(bf)
            backward_reading(f"{label}, v4s margin", pe_cm, w1g, fw6, cd_m, cases(cs.V4S_SIZES, lambda n: n), missed)
            backward_reading(f"{label}, v6 margin", pe_cm, w1g, fw6, cd_m,
                             zero_near(cases(cs.V4S_SIZES, lambda n: n + 2), fw6, pe_cm, w1g, cd_m), missed)
            del fw6, pe_cm, w1g, cd_m
            w, pe, _, cd = engine._kernel_inputs(model, tokens, coords, m.nwp[0, :n], fh[0], spec)
            c_reading(f"{label}, v2 margin", w, pe.to(bf), cd.to(bf), missed)
        torch.cuda.empty_cache()

    def seeded():
        return ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                     torch.Generator().manual_seed(0), compute_dtype=bf, device=dev,
                                     attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))

    read("seeded", seeded().model)
    step = ts.make_train_step(scfg)
    for i in range(args.trainings):
        state = seeded()
        for s in range(6):
            state, _ = step(state, batch, s >= 3)
        torch.cuda.synchronize()
        read(f"training {i}", state.model)
    fixed = missed.pop("g fixed").get(0, 0)
    print("[tie window] missed flips over all operand sets, per floor: " + "; ".join(
        f"{k}: " + ", ".join(f"{g}: {v}" for g, v in d.items()) for k, d in missed.items()), flush=True)
    print(f"[tie window] the backward's g_z and g_tz,k after fix_g_ties's recompute, over all operand sets: {fixed} "
          "elements round otherwise than cuBLAS's", flush=True)
    print("[tie window] at the kernels' floors (" + ", ".join(
        f"{k} {g}" for k, g in KERNEL_FLOORS.items()) + "), missed flips over all operand sets: " + ", ".join(
        f"{k} {missed[k][g]}" for k, g in KERNEL_FLOORS.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
