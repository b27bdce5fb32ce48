"""Phase 7's block-edge checks of the bf16 v4 backward, looped over fresh trainings.

``chip_smoke.py`` trains the seeded flagship model six steps (phase 6: three data-only, three PDE)
and then holds the v4 / v4t backward kernels to their plain version on the first points of one
145 x 257 frame (phase 7), per weight, to ``RTOL_BWD`` of its largest cotangent.  The backward's
atomic adds make each training end a few ulps apart, so the frame's operands move from run to run.
This script repeats that training from the seeded state ``--trainings`` times and, after each, runs
phase 7's backward checks at the block edges (1, 17, 64, 65, 129 points: cotangents seeded as phase
7 seeds them, zero at the points near a relu kink), both layouts.  It prints one line a training:
for each size the worst weight's error, and for w1 and w1c the error beside what flipped bf16
roundings of the row cotangents g_z and g_tz,k would explain: the tensor cores' sum of g_r W^T
(emulated as ``tie_window`` emulates the forwards' sums) against cuBLAS's, each element that rounds
the other way moved by its one step, contracted as ``gw1 = pe^T g_z`` and ``gw1c[k] = tan_k^T
g_tz,k``.  Its last lines count the trainings whose checks all passed, and the errors above
``EXPLAIN_FROM`` that those flips explain to within a fifth.  Run from the repository's root on a
machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.backward_edges --trainings 50
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

EDGE_SIZES = (1, 17, 64, 65, 129)
EXPLAIN_FROM = 1e-4  # errors of w1 / w1c above this share of their largest (f32 sum orders read ~1e-6)


def cotangents(n: int, seed: int, n_vars: int, dev):
    """chip_smoke.py's seeded cotangents of a backward check: ([V, n], [3, V, n]) float32."""
    g = np.random.RandomState(seed)
    return (torch.from_numpy(g.randn(n_vars, n).astype(np.float32)).to(dev),
            torch.from_numpy(g.randn(3, n_vars, n).astype(np.float32)).to(dev))


def near_kink(fw, pe, w1, cd_pe, dtype, kink_eps: float):
    """[N] bool: the points with a relu argument of the plain version within ``kink_eps`` (1 + the
    largest argument) of zero, as chip_smoke.py's ``near_kink``."""
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    z = dot_f32(pe, w1, dtype) + fw.b1[:, None, :]
    near = (z.abs() < kink_eps * (1.0 + float(z.abs().max()))).any(-1).any(0)
    r = dot_f32(torch.relu(z), fw.w2f1, dtype) + dot_f32(cd_pe, fw.wdf1, dtype) + fw.rbias[:, None, :]
    return near | (r.abs() < kink_eps * (1.0 + float(r.abs().max()))).any(-1).any(0)


def row_cotangents(pe, w1, fw, cd_pe, g_p, g_t, matmul):
    """The plain backward's g_z [V, N, H] and g_tz [3, V, N, H] before their bf16 rounding, with
    g_r W^T summed by ``matmul(x, y)`` (cuBLAS: ``dot_f32``; the tensor cores: ``tie_window.emulated``);
    ``pe`` [N, in_ch] by ``w1`` [V, in_ch, H] is layer 1 (z's and r's masks come from the primal
    chain alone), ``g_p`` [V, N] and ``g_t`` [3, V, N] the var-major cotangents."""
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    bf = torch.bfloat16
    z = dot_f32(pe, w1, bf) + fw.b1[:, None, :]
    mask = z > 0
    rp = dot_f32(torch.relu(z), fw.w2f1, bf) + dot_f32(cd_pe, fw.wdf1, bf) + fw.rbias[:, None, :]
    maskr = rp > 0
    go, gto = g_p.float()[:, :, None], g_t.float()[..., None]
    a_v, b_v = fw.fw2.float()[:, None, :], fw.w2wo.float()[:, None, :]
    wt = fw.w2f1.transpose(-1, -2)
    g_rp = torch.where(maskr, go * a_v, 0.0)
    g_z = torch.where(mask, matmul(g_rp, wt) + 2.0 * (go * b_v), 0.0)
    del g_rp
    g_rt = torch.where(maskr[None], gto * a_v[None], 0.0)
    g_tz = torch.where(mask[None], matmul(g_rt, wt[None]) + 2.0 * (gto * b_v[None]), 0.0)
    return g_z, g_tz


def sequential(x, y):
    """x @ y summed one FMA a term in k order from zero (a product of two bf16 values is exact in
    f32, so an add of it rounds once, as an FMA does)."""
    bf = torch.bfloat16
    x, y = x.to(bf).float(), y.to(bf).float()
    s = torch.zeros(*torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]), x.shape[-2], y.shape[-1], device=x.device)
    for k in range(x.shape[-1]):
        s = s + x[..., :, k, None] * y[..., k, None, :]
    return s


def flip_explains(pe, w1, tins, fw, cd_pe, g_p, g_t, want):
    """What the g_z / g_tz roundings the tensor cores flip (emulated) move gw1 and gw1c by, as a
    share of each one's largest plain cotangent; and how many elements flip."""
    from deepphysinet_tpu_torch.diagnostics.tie_window import emulated
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    bf = torch.bfloat16
    seq = row_cotangents(pe, w1, fw, cd_pe, g_p, g_t, lambda x, y: dot_f32(x, y, bf))
    tc = row_cotangents(pe, w1, fw, cd_pe, g_p, g_t, emulated)
    d_z = tc[0].to(bf).float() - seq[0].to(bf).float()
    d_t = tc[1].to(bf).float() - seq[1].to(bf).float()
    dw1 = torch.matmul(pe.to(bf).float().t(), d_z)
    dw1c = torch.stack([torch.matmul(tins[k].to(bf).float().t(), d_t[k]) for k in range(3)], dim=1)
    def share(d, w):  # as backward_check's: absolute where the plain cotangent is all zeros
        scale = float(w.abs().max())
        return float(d.abs().max()) / scale if scale > 0 else float(d.abs().max())

    return int((d_z != 0).sum()), int((d_t != 0).sum()), share(dw1, want.w1), share(dw1c, want.w1c)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trainings", type=int, default=50, help="fresh trainings of six steps from the seeded weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backward_edges: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the repository's root is on the path under ``python -m``
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    cfg = Config.fromfile(cs.FLAGSHIP_CFG)["config"]
    scfg = ts.step_config_from_cfg(cfg)
    dcfg = runner.decode_config_from_cfg(cfg)
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    window = synthetic_window(cfg, seed=0)
    field = torch.from_numpy(window.field[None]).to(dev)
    n_vars, n_max = len(dcfg.obs_specs), max(EDGE_SIZES)
    xs, ys = np.meshgrid(np.arange(257.0), np.arange(145.0))
    px, py, pt, nwp, _ = window.get_margin_grid(xs.ravel()[:n_max], ys.ravel()[:n_max], np.full(n_max, 6.5))
    coords, nwp_t = torch.from_numpy(np.stack([px, py, pt], -1)).to(dev), torch.from_numpy(nwp).to(dev)
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    step = ts.make_train_step(scfg)
    passed, worst, large, explained = 0, {n: 0.0 for n in EDGE_SIZES}, 0, 0
    for i in range(args.trainings):
        state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                      torch.Generator().manual_seed(0), compute_dtype=bf, device=dev,
                                      attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
        for s in range(6):
            state, _ = step(state, batch, s >= 3)
        model = state.model
        with torch.no_grad():
            tokens = runner._encode(model, field, fh_norm)
            w, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens, coords, nwp_t, torch.tensor([fh_norm], device=dev),
                                                      dcfg.coord_spec)
            fw = dk.fuse_decode_weights(w)
        pe, dpe, cd_pe = pe.to(bf), dpe.to(bf), cd_pe.to(bf)
        failed, parts = [], []
        for n in EDGE_SIZES:
            ins = (fw, pe[:n].contiguous(), dpe[:, :n].contiguous(), cd_pe[:n].contiguous())
            near = near_kink(fw, ins[1], fw.w1, ins[3], bf, cs.KINK_EPS)
            g_p, g_t = cotangents(n, n + 1, n_vars, dev)
            g_p[:, near], g_t[:, :, near] = 0.0, 0.0
            got_t = dk.decode_bwd_kernel_v4t(*ins, g_p, g_t, bf)
            got_n = dk.decode_bwd_kernel_v4(*ins, g_p.t().contiguous(), g_t.transpose(1, 2).contiguous(), bf)
            want = dk.decode_bwd_v4_ref(*ins, g_p, g_t, bf, t_layout=True)
            rel = {}
            for layout, got in (("[6, N]", got_t), ("[N, 6]", got_n)):
                for name in want._fields:
                    b_ = getattr(want, name)
                    scale = float(b_.abs().max())
                    err = float((getattr(got, name) - b_).abs().max())
                    rel[(layout, name)] = err / scale if scale > 0 else err
            (layout, name), r = max(rel.items(), key=lambda kv: kv[1])
            worst[n] = max(worst[n], r)
            nz, nt, ew1, ew1c = flip_explains(ins[1], fw.w1, [ins[2][k] for k in range(3)], fw, ins[3], g_p, g_t, want)
            obs = {w: max(rel[("[6, N]", w)], rel[("[N, 6]", w)]) for w in ("w1", "w1c")}
            for w, e in (("w1", ew1), ("w1c", ew1c)):
                if obs[w] > EXPLAIN_FROM:
                    large += 1
                    explained += abs(obs[w] - e) <= 0.2 * obs[w]
            parts.append(f"N={n} {r:.2e} ({name} {layout}; w1 {obs['w1']:.1e} / flips {ew1:.1e}, "
                         f"w1c {obs['w1c']:.1e} / flips {ew1c:.1e}, {nz} + {nt} flips)")
            if r > cs.RTOL_BWD[bf]:
                failed.append(f"N={n} {name} {layout} {r:.3e} > {cs.RTOL_BWD[bf]:.0e}")
        passed += not failed
        print(f"[backward edges] training {i}: worst per weight |kernel - plain| / max|plain|: " + ", ".join(parts)
              + ("; FAILED " + "; ".join(failed) if failed else ""), flush=True)
        del state, model
        torch.cuda.empty_cache()
    print(f"[backward edges] {passed} of {args.trainings} trainings passed every block-edge check of the bf16 v4 "
          f"backward (bound {cs.RTOL_BWD[bf]:.0e}); worst by size: "
          + ", ".join(f"N={n} {v:.2e}" for n, v in worst.items()), flush=True)
    print(f"[backward edges] {explained} of the {large} w1 / w1c errors above {EXPLAIN_FROM:.0e} of their largest "
          "lie within a fifth of what the emulated g_z / g_tz,k flips move them by", flush=True)
    return 0 if passed == args.trainings else 1


if __name__ == "__main__":
    sys.exit(main())
