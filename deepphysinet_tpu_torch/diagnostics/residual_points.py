"""Phase 11's residual-sum checks, looped over fresh trainings, with the points where the kernel parts.

``chip_smoke.py`` trains the seeded flagship model six steps (phase 6: three data-only, three PDE)
and then holds the residual-sum kernels (``fused_residual_sums_v4`` / ``_v6``) to their plain
versions on seeded window points (phase 11): per equation, to ``RTOL_RESIDUAL`` of the plain sum,
the vapor sum also within the terms of its points near a switch.  The backward's atomic adds make
each training end a few ulps apart, so the operands move from run to run.  This script repeats
that training ``--trainings`` times and, after each, runs phase 11's checks (both versions, both
types, with and without the clip, at ``--sizes``, the same points left out), and prints each check
whose error reaches ``--report`` of its bound (each equation also allowed the decode's own
disagreement carried through its terms, ``chip_smoke.residual_check``), with the point that carries
it: the check's chunks of
points are summed by the kernel and the plain version apart, the chunk that parts most is halved
again down to one point, and that point's kernel term (a launch of its own) is set beside its plain
term.  For the point it prints its physical fields, the relu argument of its decode (z of layer 1,
r of layer 2) nearest zero in units of 2^-24 times the largest |argument| of its row, and whether
the plain decode with that one relu switched the other way gives the kernel's terms (to within a
tenth of the difference): a kink, the decode's discontinuity, where the kernel's sum of the
argument lands on the other side of zero than cuBLAS's.  Each training also holds the bf16 v4 and
v6 forwards (the residual kernel's decode body) to their plain versions at the largest size's
points, the points near a kink (``chip_smoke.KINK_EPS``) included, per tangent relative to its
largest value, and counts the points that part by ``FLIP_FROM`` or more.  Its last line counts the
checks that failed, the kinks among the points reported and those points.  It exits with 1 when a
check failed.  Run from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.residual_points --trainings 40

``--perturb EQUATION`` is the checks' negative control: it builds the residual-sum kernels from a
copy of the sources (under ``csrc/build/``) in which that equation's residual is scaled by
sqrt(1 + 1e-3), so each of its per-point terms by 1 + 1e-3, runs the checks on that build and
counts the failures by size; it exits with 0 only when a check failed at every size.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.residual_kernel import EQUATIONS

EPS = 2.0 ** -24
CHUNKS = 32  # chunks a step of the search halves a check's points into
FLIP_FROM = 1e-5  # a tangent error of this share of its largest or more is a relu switched the other way


def cs_near_kink(dk, fw, pe, w1, cd_pe, dtype, kink_eps: float):
    """[N] bool: chip_smoke.py's ``near_kink``, the points with a relu argument of the plain
    version within ``kink_eps`` (1 + the largest argument) of zero."""
    z = dk.dot_f32(pe, w1, dtype) + fw.b1[:, None, :]
    near = (z.abs() < kink_eps * (1.0 + float(z.abs().max()))).any(-1).any(0)
    r = dk.dot_f32(torch.relu(z), fw.w2f1, dtype) + dk.dot_f32(cd_pe, fw.wdf1, dtype) + fw.rbias[:, None, :]
    return near | (r.abs() < kink_eps * (1.0 + float(r.abs().max()))).any(-1).any(0)


def plain_decode(l1, fw, cd_pe, ref_t, cdt, flip=None):
    """``ops/decode_kernel.py::_jvp_ref`` (rounded tangents) with, where ``flip`` is (layer, v, n, c),
    relu switch c of variable v at point n of layer 1 (z) or 2 (r) turned the other way: the
    switch alone, the argument's value kept.  ([V, N], [3, V, N]) float32."""
    from deepphysinet_tpu_torch.ops.precision import dot_f32

    def flipped(mask, layer):
        if flip is None or flip[0] != layer:
            return mask
        mask = mask.clone()
        mask[flip[1], flip[2], flip[3]] = ~mask[flip[1], flip[2], flip[3]]
        return mask

    z = dot_f32(l1.pe, l1.w1, cdt) + fw.b1[:, None, :]
    mask = flipped(z > 0, 1)
    p = torch.where(mask, z, 0.0)
    t = torch.stack([torch.where(mask, dot_f32(l1.tin[k], l1.w1k[:, k], cdt), 0.0) for k in range(3)])
    t = t.to(cdt).float()
    rp = dot_f32(p, fw.w2f1, cdt) + dot_f32(cd_pe, fw.wdf1, cdt) + fw.rbias[:, None, :]
    maskr = flipped(rp > 0, 2)
    pr = torch.where(maskr, rp, 0.0)
    tr = torch.where(maskr[None], dot_f32(t, fw.w2f1[None], cdt), 0.0)
    o = ((pr * fw.fw2[:, None, :]).sum(-1)
         + 2.0 * ((p * fw.w2wo[:, None, :]).sum(-1) + torch.einsum("nk,vk->vn", cd_pe.float(), fw.wdwo.float()))
         + fw.obias[:, None] + ref_t)
    to = ((tr * fw.fw2[None, :, None, :]).sum(-1) + 2.0 * (t * fw.w2wo[None, :, None, :]).sum(-1))
    return o, to, z, rp


def decode_kinks(kernel_fn, plain_fn, near, ins, dtype, flip_from: float):
    """The kernel's forward against its plain version on the same points, per tangent relative to
    the largest |plain value| of its direction and variable: the largest error outside and inside
    the near-kink set ``near`` [N], and the points whose error reaches ``flip_from`` (a relu switched
    the other way moves a tangent by about 1e-4 to 1e-2 of its largest, rounding by about 1e-7)."""
    _, t_k = kernel_fn(*ins, dtype)
    _, t_p = plain_fn(*ins, dtype)
    err = ((t_k - t_p).abs() / t_p.abs().amax(1, keepdim=True).clamp_min(1e-30)).amax(0).amax(-1)  # [N]
    off = err >= flip_from
    return (float(err[~near].max()) if bool((~near).any()) else 0.0,
            float(err[near].max()) if bool(near.any()) else 0.0, int(off.sum()), int((off & near).sum()))


def part_point(kernel, e, ins, cor, specs, with_clip, dtype, primal, tang, version):
    """The point that carries equation e's error of a check, found by halving chunks of points
    (``kernel(idx)`` sums the points at ``idx``), and what it is: ``(point, a kink?, text)``.
    ``primal`` [N, 6] and ``tang`` [3, N, 6] are the check's plain decode of ``ins``."""
    from deepphysinet_tpu_torch.ops import decode_kernel as dk, residual_kernel as rk
    from deepphysinet_tpu_torch.physics import engine

    terms = rk.residual_point_terms(primal, tang, cor, specs, with_clip)
    idx = torch.arange(primal.shape[0], device=primal.device)
    while idx.numel() > 1:
        parts = torch.tensor_split(idx, min(CHUNKS, idx.numel()))
        diffs = [abs(float(kernel(c)[e]) - float(terms[e, c].double().sum())) for c in parts]
        idx = parts[int(np.argmax(diffs))]
    pt = int(idx[0])
    k_pt, p_pt = kernel(idx), terms[:, pt]
    fw, cd_pe, ref_t = ins[0], ins[-2], ins[-1].float().t()
    l1 = dk._layer1_v6(fw, ins[1]) if version == 6 else dk._layer1_v4(fw, ins[1], ins[2])
    _, _, z, r = plain_decode(l1, fw, cd_pe, ref_t, dtype)
    near = []  # per layer, the point's relu argument nearest zero, in 2^-24 of its row's largest |value|
    for layer, a in ((1, z[:, pt]), (2, r[:, pt])):
        d = a.abs() / a.abs().amax(-1, keepdim=True).clamp_min(1e-30) / EPS  # [V, H]
        v, c = divmod(int(d.argmin()), d.shape[-1])
        near.append((float(d[v, c]), layer, v, c))
    best = None
    for _, layer, v, c in near:  # that relu switched in the check's own plain decode
        o2, to2, _, _ = plain_decode(l1, fw, cd_pe, ref_t, dtype, (layer, v, pt, c))
        t2 = rk.residual_point_terms(o2[:, pt:pt + 1].t(), to2[:, :, pt:pt + 1].transpose(1, 2), cor[pt:pt + 1],
                                     specs, with_clip)[:, 0]
        miss = float((t2[e] - k_pt[e]).abs())
        if best is None or miss < best[0]:
            best = (miss, layer, v, c)
    explained = best[0] <= 0.1 * float((k_pt[e] - p_pt[e]).abs())
    phys, _ = engine.packed_physical_from_primal_tangents(primal[pt:pt + 1], tang[:, pt:pt + 1], specs, with_clip)
    fields = " ".join(f"{k}={float(phys[i, 0]):.4g}" for i, k in enumerate(rk.FIELD_KEYS))
    total = float(terms[e].double().sum())
    share = float(k_pt[e] - p_pt[e]) / total if total else float("inf")
    text = (f"kernel term {float(k_pt[e]):.6g}, plain {float(p_pt[e]):.6g} ({share:.3e} of the sum); {fields}; "
            "nearest relu arguments: " + ", ".join(f"{'zr'[lay - 1]} var {v} col {c} at {d:.3g}"
                                                   for d, lay, v, c in near)
            + f"; {'zr'[best[1] - 1]} of var {best[2]} col {best[3]} switched gives the kernel's term to "
            f"{best[0]:.3g}: {'a kink' if explained else 'not a kink'}")
    return pt, explained, text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trainings", type=int, default=40, help="fresh trainings of six steps from the seeded weights")
    ap.add_argument("--sizes", type=str, default="", help="comma-separated point counts (default: phase 11's)")
    ap.add_argument("--report", type=float, default=0.25, help="print the checks whose error reaches this share "
                    "of their bound")
    ap.add_argument("--perturb", choices=EQUATIONS, default=None, help="the negative control: scale this "
                    "equation's per-point terms by 1 + 1e-3 in a build of the kernels from a copy of the sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("residual_points: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the repository's root is on the path under ``python -m``
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import cuda_build, decode_kernel as dk, residual_kernel as rk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    if args.perturb:
        perturbed_library(cs, cuda_build, rk, EQUATIONS.index(args.perturb))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes else cs.RESIDUAL_SIZES
    cfg = Config.fromfile(cs.FLAGSHIP_CFG)["config"]
    scfg = ts.step_config_from_cfg(cfg)
    dcfg = runner.decode_config_from_cfg(cfg)
    specs = scfg.obs_specs
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    window = synthetic_window(cfg, seed=0)
    field = torch.from_numpy(window.field[None]).to(dev)
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    points = {}
    for n in sizes:  # phase 11's window_points
        g = np.random.RandomState(n)
        px, py, pt, nwp, cor = window.get_margin_grid(g.rand(n) * 256.0, g.rand(n) * 144.0, g.rand(n) * 24.0)
        points[n] = (torch.from_numpy(np.stack([px, py, pt], -1)).to(dev), torch.from_numpy(nwp).to(dev),
                     torch.from_numpy(cor).to(dev))
    fns = {4: (rk.fused_residual_sums_v4, rk.residual_sums_v4_ref, dk.decode_jvp_v4_ref, dk.fused_decode_jvp_v4),
           6: (rk.fused_residual_sums_v6, rk.residual_sums_v6_ref, dk.decode_jvp_v6_ref, dk.fused_decode_jvp_v6)}
    step = ts.make_train_step(scfg)
    n_checks, failed, reported, kinks = 0, 0, 0, 0
    failed_at = {n: 0 for n in sizes}
    bits = [0, 0]  # points sampled, the kernel's term equal to the forward kernel's decode's
    flips, flips_near = 0, 0
    decode_fns = {4: (dk.fused_decode_jvp_v4, dk.decode_jvp_v4_ref), 6: (dk.fused_decode_jvp_v6, dk.decode_jvp_v6_ref)}
    n_decode = max(sizes)
    for it in range(args.trainings):
        state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                      torch.Generator().manual_seed(0), compute_dtype=bf, device=dev,
                                      attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
        for s in range(6):
            state, _ = step(state, batch, s >= 3)
        model = state.model
        model.eval()
        worst_it = 0.0
        with torch.no_grad():
            tokens = runner._encode(model, field, fh_norm)
            fh = torch.tensor([fh_norm], device=dev)

            def inputs(version, n):
                """The residual wrapper's arguments up to the conditioning values, as phase 11's."""
                coords, nwp, _ = points[n]
                if version == 6:
                    fw6, trig, cd_pe = engine._kernel_inputs_6(model, tokens, coords, nwp, fh, scfg.coord_spec)
                    return fw6, trig, cd_pe, nwp
                w, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens, coords, nwp, fh, scfg.coord_spec)
                return dk.fuse_decode_weights(w), pe, dpe, cd_pe, nwp

            # the bf16 forwards (the residual kernel's decode body) on the largest size's points
            parts = []
            for version, (kfn_d, pfn_d) in decode_fns.items():
                ins = inputs(version, n_decode)
                ins = (ins[0], *(x.to(bf) for x in ins[1:-1]), ins[-1])
                l1 = dk._layer1_v6(ins[0], ins[1]) if version == 6 else dk._layer1_v4(ins[0], ins[1], ins[2])
                near = cs_near_kink(dk, ins[0], l1.pe, l1.w1, ins[-2], bf, cs.KINK_EPS)
                e_off, e_near, n_off, n_off_near = decode_kinks(kfn_d, pfn_d, near, ins, bf, FLIP_FROM)
                flips += n_off
                flips_near += n_off_near
                parts.append(f"v{version} {e_off:.2e} away from a kink, {e_near:.2e} at the {int(near.sum())} "
                             f"points near one; {n_off} points at {FLIP_FROM:.0e} or more ({n_off_near} near a kink)")
            print(f"[residual points] training {it}: bf16 forward tangents at {n_decode} points, "
                  "|kernel - plain| / max|plain|: " + "; ".join(parts), flush=True)
            for n in sizes:
                cor = points[n][2]
                for version, (kfn, pfn, dref, _) in fns.items():
                    all_ins = inputs(version, n)
                    for dtype in (bf, f32):
                        ins = (all_ins[0], *(x.to(dtype) for x in all_ins[1:-1]), all_ins[-1])
                        for with_clip in (True, False):
                            # phase 11's points: the terms finite, without the clip p and T inside their bounds
                            primal, tang = dref(*ins, dtype)
                            keep = torch.isfinite(rk.residual_point_terms(primal, tang, cor, specs, with_clip)).all(0)
                            if not with_clip:
                                for v_ in (2, 3):
                                    sp = specs[v_]
                                    phys = primal[:, v_] * sp.norm_factor[1] + sp.norm_factor[0]
                                    keep &= (phys > sp.bound[0]) & (phys < sp.bound[1])
                            if not bool(keep.any()):
                                continue
                            ins_k, cor_k = cs.point_subset(ins, keep), cor[keep].contiguous()
                            rtol = cs.RTOL_RESIDUAL[dtype]
                            chk = cs.residual_check(rk, engine, scfg, fns[version], ins_k, cor_k, with_clip, dtype,
                                                    rtol)
                            primal, tang = chk["primal"], chk["tang"]

                            def kernel(idx):
                                return kfn(*cs.point_subset(ins_k, idx), cor_k[idx].contiguous(), specs,
                                           with_clip=with_clip, compute_dtype=dtype)

                            got, want = chk["got"], chk["want"]
                            limit = rtol * want.abs() + torch.tensor(chk["extra"], device=dev)
                            diff = (got - want).abs()
                            ratio = torch.where(diff == 0, 0.0, diff / limit)
                            e = int(ratio.argmax())
                            n_checks += 1
                            failed += not all(chk["ok"])
                            failed_at[n] += not all(chk["ok"])
                            bits[0] += chk["sample"]
                            bits[1] += chk["bits_equal"]
                            worst_it = max(worst_it, float(ratio[e]))
                            if args.perturb:
                                print(f"[residual points] training {it} v{version} {str(dtype)[6:]} N={n} "
                                      f"clip={with_clip}: {'failed' if not all(chk['ok']) else 'passed'}, "
                                      f"{rk.EQUATIONS[e]} at {float(ratio[e]):.3g} of its bound; allowance: "
                                      f"{cs.allowance_text(chk, rtol)}", flush=True)
                                continue
                            if float(ratio[e]) < args.report:
                                continue
                            reported += 1
                            pt_, explained, about = part_point(kernel, e, ins_k, cor_k, specs, with_clip, dtype,
                                                               primal, tang, version)
                            kinks += explained
                            print(f"[residual points] training {it} v{version} {str(dtype)[6:]} N={n} "
                                  f"clip={with_clip}: {rk.EQUATIONS[e]} at {float(ratio[e]):.3g} of its bound "
                                  f"({float(((got - want) / want)[e]):.3e} of the plain sum); allowance: "
                                  f"{cs.allowance_text(chk, rtol)}; point {pt_}: {about}", flush=True)
        print(f"[residual points] training {it}: worst check at {worst_it:.3g} of its bound", flush=True)
        del state, model
        torch.cuda.empty_cache()
    print(f"[residual points] the decode's bits: the kernel's term at {bits[0]} points (each a launch of its own) "
          f"equals the term of the forward kernel's decode at {bits[1]}", flush=True)
    if args.perturb:
        print(f"[residual points] negative control, {args.perturb}'s terms scaled by 1 + 1e-3: failed checks by "
              "size " + ", ".join(f"N={n}: {k}" for n, k in failed_at.items()) + f" ({failed} of {n_checks})",
              flush=True)
        return 0 if all(failed_at.values()) else 1
    print(f"[residual points] {failed} of {n_checks} checks failed over {args.trainings} trainings; of the "
          f"{reported} checks at {args.report} of their bound or more, {kinks} part at a point where one relu "
          f"switched the other way explains the kernel's term; the bf16 forwards parted at {flips} points by "
          f"{FLIP_FROM:.0e} of a tangent's largest or more, {flips_near} of them near a kink", flush=True)
    return 0 if failed == 0 else 1


def perturbed_library(cs, cuda_build, rk, e: int) -> None:
    """Route the residual-sum wrappers to a build in which equation e's residual is scaled by
    sqrt(1 + 1e-3) (its squared term by 1 + 1e-3), made from a copy of the sources."""
    gas = "  out[5] = sub(p, mul(mul(mul(rho, add(1.0f, mul(0.608f, q))), c.r_d), temp));"
    real = rk._library()
    lib = cs.variant_library(cuda_build, rk.SOURCE, f"perturbed_{EQUATIONS[e]}", "residual_equations.cuh", gas,
                             gas + f"\n  out[{e}] = mul(out[{e}], {np.sqrt(1.0 + 1e-3):.9f}f);")
    for name in ("dpn_residual_sums", "dpn_residual_sums_hid", "dpn_residual_sums_block",
                 "dpn_residual_sums_shared_bytes", "dpn_residual_sums_scratch_floats", "dpn_residual_sums_tickets"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = getattr(real, name).restype
    rk._library = lambda: lib
    print(f"[residual points] negative control: residual-sum kernels from a copy of the sources with "
          f"{EQUATIONS[e]}'s residual scaled by {np.sqrt(1.0 + 1e-3):.9f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
