"""Where the split path's residual losses part from the in-kernel assembly's, over many point sets.

``chip_smoke.py`` holds ``kernel_residual_losses`` (one launch; its decode sums in the plain
version's order) to the split path (the v4t or v6 forward kernel, whose bf16 products run on
the tensor cores in another order, then the assembly) on three point sets, per loss within
``RTOL_RESIDUAL``, the vapor loss also allowed the terms of the points near a switch of its
term (``chip_smoke.vapor_switch_set``).  This script repeats the comparison on many seeded
point sets of the flagship window, for several trainings of the seeded model as the main path
trains it (six steps; its backward adds by atomics, so each training ends a few ulps apart),
and prints one JSON line a set and version, then a summary:

* the largest change of one point's vapor term between the two decodes, as a share of the
  vapor sum, at points inside and outside the switch set, and the switch set's allowance;
* every point whose delta = 1[Dp/Dt < 0 and q >= q_s] differs between the two decodes, with
  what lies near it (chip_smoke.py's windows): Dp/Dt = 0, q = q_s, the pole of q_s, a clip
  bound of p or q, a relu kink;
* how many sets fail the check through the entry points.

Run from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.switch_census --trainings 12 --sets 100
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

LOSS_KEYS = ("montion_u_loss", "montion_v_loss", "continous_loss", "energy_loss", "vapor_loss", "gas_loss")


def main() -> int:
    import chip_smoke as cs  # the repository's root is on the path under ``python -m``
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.ops import decode_kernel as dk, residual_kernel as rk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trainings", type=int, default=4)
    ap.add_argument("--sets", type=int, default=100, help="point sets a training, besides chip_smoke.py's")
    ap.add_argument("--points", type=int, default=50001)
    ap.add_argument("--bound-eps", type=float, default=None,
                    help="the window of a clip bound, times 1 + the field's largest (default chip_smoke.KINK_EPS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("switch_census needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config.fromfile(cs.FLAGSHIP_CFG)["config"]
    cd = torch.bfloat16
    eps, rtol = cs.SWITCH_EPS[cd], cs.RTOL_RESIDUAL[cd]
    bound_eps = cs.KINK_EPS if args.bound_eps is None else args.bound_eps
    scfg = ts.step_config_from_cfg(cfg)
    dcfg = runner.decode_config_from_cfg(cfg)
    window = synthetic_window(cfg, seed=0)
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    field = torch.from_numpy(window.field[None]).to(dev)
    unit = {k: 1.0 for k in scfg.loss_factor}
    fh_norm = window.forecast_h / dcfg.forecast_time_period
    fh = torch.tensor([fh_norm], device=dev)

    def window_points(n, seed):  # chip_smoke.py's point sets
        g = np.random.RandomState(seed)
        px, py, pt, nwp, cor = window.get_margin_grid(g.rand(n) * 256.0, g.rand(n) * 144.0, g.rand(n) * 24.0)
        return (torch.from_numpy(np.stack([px, py, pt], -1)).to(dev), torch.from_numpy(nwp).to(dev),
                torch.from_numpy(cor).to(dev))

    def near_kink(fw, pe, w1, cd_pe):  # chip_smoke.py's kink set
        z = dk.dot_f32(pe, w1, cd) + fw.b1[:, None, :]
        near = (z.abs() < cs.KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
        r = dk.dot_f32(torch.relu(z), fw.w2f1, cd) + dk.dot_f32(cd_pe, fw.wdf1, cd) + fw.rbias[:, None, :]
        return near | (r.abs() < cs.KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0)

    @torch.no_grad()
    def decodes(model, tokens, coords, nwp, version):
        """The plain decode (the in-kernel assembly's rounding), the split path's and the kink set."""
        if version == 6:
            fw6, trig, cd_pe = engine._kernel_inputs_6(model, tokens, coords, nwp, fh, scfg.coord_spec)
            trig, cd_pe = trig.to(cd), cd_pe.to(cd)
            pe = trig.permute(1, 0, 2).reshape(trig.shape[1], -1)
            return (*dk.decode_jvp_v6_ref(fw6, trig, cd_pe, nwp, cd), *dk.fused_decode_jvp_v6(fw6, trig, cd_pe, nwp, cd),
                    near_kink(fw6, pe, fw6.w1g.reshape(6, -1, fw6.w1g.shape[-1]), cd_pe))
        weights, pe, dpe, cd_pe = engine._kernel_inputs(model, tokens, coords, nwp, fh, scfg.coord_spec)
        fw = dk.fuse_decode_weights(weights)
        pe, dpe, cd_pe = pe.to(cd), dpe.to(cd), cd_pe.to(cd)
        return (*dk.decode_jvp_v4_ref(fw, pe, dpe, cd_pe, nwp, cd), *dk.fused_decode_jvp_v4(fw, pe, dpe, cd_pe, nwp, cd),
                near_kink(fw, pe, fw.w1, cd_pe))

    def fields(primal, tang):
        P, D = engine.packed_physical_from_primal_tangents(primal, tang, scfg.obs_specs, True)
        dp = D[2, 2] + P[0] * D[0, 2] + P[1] * D[1, 2]
        q_s = torch.clamp(engine.saturation_specific_humidity_packed(P[2], P[3]), min=1e-6)
        e_s = 6.112 * torch.exp(17.67 * (P[3] - 273.15) / (P[3] - 273.15 + 243.5)) * 100.0
        return dict(delta=(dp < 0) & (P[4] >= q_s), dp=dp, q=P[4], q_s=q_s, pole=(P[2] - 0.378 * e_s) / P[2],
                    norm={i: primal[:, i] for i in (2, 4)})

    def kinds(f, i, kink):
        """What lies near point i's switches in the plain decode, by chip_smoke.py's windows (a
        bound's: KINK_EPS, whatever --bound-eps is)."""
        out = []
        if f["dp"][i] != 0 and f["dp"][i].abs() < eps * f["dp"].abs().max():
            out.append("Dp/Dt = 0")
        if f["q"][i] != f["q_s"][i] and (f["q"][i] - f["q_s"][i]).abs() < eps * f["q_s"][i]:
            out.append("q = q_s")
        if f["pole"][i].abs() < eps:
            out.append("pole of q_s")
        for v, name in ((2, "p"), (4, "q")):
            spec, x = scfg.obs_specs[v], f["norm"][v]
            win = cs.KINK_EPS * (1.0 + float(x.abs().max()))  # whatever window the rule takes
            if any(abs(float(x[i]) - (b - spec.norm_factor[0]) / spec.norm_factor[1]) < win for b in spec.bound):
                out.append(f"bound of {name}")
        if kink:
            out.append("relu kink")
        return out

    def through_entry_points(model, tokens, coords, nwp, cor, version, primal, tang, n):
        """chip_smoke.py's check: per loss within rtol, vapor also allowed the switch set's terms."""
        call = (model, tokens, coords, nwp, fh, cor, scfg.coord_spec, scfg.obs_specs, unit)
        crossover = engine.FUSED_ASSEMBLY_MIN_N
        engine.FUSED_ASSEMBLY_MIN_N = 10**9
        try:
            split = engine.fused_residual_losses(*call, version=version)
        finally:
            engine.FUSED_ASSEMBLY_MIN_N = crossover
        fused = rk.kernel_residual_losses(*call, version=version)
        rel = {k: abs(float(fused[k]) - float(split[k])) / abs(float(split[k])) for k in LOSS_KEYS}
        _, moved = cs.vapor_switch_points(engine, scfg, primal, tang, True, eps, bound_eps)
        limit = rtol + moved / (float(split["vapor_loss"]) * n)
        return rel, limit, all(r <= rtol for k, r in rel.items() if k != "vapor_loss") and rel["vapor_loss"] <= limit

    rows, flips, t0 = [], [], time.time()
    for training in range(args.trainings):
        state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                      torch.Generator().manual_seed(0), compute_dtype=cd, device=dev,
                                      attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
        step = ts.make_train_step(scfg)
        for i in range(6):
            state, _ = step(state, batch, i >= 3)
        model = state.model.eval()
        tokens = runner._encode(model, field, fh_norm)
        sets = [(n, n) for n in cs.RESIDUAL_SIZES] + [(args.points, 1000 + s) for s in range(args.sets)]
        for n, seed in sets:
            coords, nwp, cor = window_points(n, seed)
            for version in (4, 6):
                primal, tang, kp, kt, kink = decodes(model, tokens, coords, nwp, version)
                flagged, size = cs.vapor_switch_set(engine, scfg, primal, tang, True, eps, bound_eps)
                plain = rk.residual_point_terms(primal, tang, cor, scfg.obs_specs, True).double()
                split = rk.residual_point_terms(kp, kt, cor, scfg.obs_specs, True).double()
                total = float(plain[4].sum())
                share = (split[4] - plain[4]).abs() / total
                row = dict(training=training, n=n, seed=seed, version=version, flagged=int(flagged.sum()),
                           kink=int(kink.sum()), allowance=float(size[flagged].sum()) / total,
                           largest_flagged=float(share[flagged].max()) if bool(flagged.any()) else 0.0,
                           largest_unflagged=float(share[~flagged].max()))
                for v, name in ((2, "p"), (4, "q")):  # the bound windows' share of the allowance
                    spec, x = scfg.obs_specs[v], primal[:, v]
                    win = bound_eps * (1.0 + float(x.abs().max()))
                    on_bound = torch.zeros_like(flagged)
                    for b in spec.bound:
                        on_bound |= (x - (b - spec.norm_factor[0]) / spec.norm_factor[1]).abs() < win
                    gap = (kp[:, v] - x).abs()
                    row[f"bound_{name}"] = dict(points=int(on_bound.sum()), allowance=float(size[on_bound].sum()) / total,
                                                window=win, largest=float(x.abs().max()),
                                                differ_max=float(gap.max()),
                                                differ_rel_max=float((gap / (1.0 + x.abs())).max()))
                bad = ~torch.isfinite(plain).all(0)
                if bool(bad.any()):  # a non-finite term: which points, and what their fields are
                    P, _ = engine.packed_physical_from_primal_tangents(primal, tang, scfg.obs_specs, True)
                    row["non_finite"] = [dict(point=i, fields=P[:, i].tolist(), terms=plain[:, i].tolist(),
                                              tangent_max=float(tang[:, i].abs().max()))
                                         for i in torch.nonzero(bad).flatten().tolist()[:4]]
                fa, fb = fields(primal, tang), fields(kp, kt)
                for i in torch.nonzero(fa["delta"] != fb["delta"]).flatten().tolist():
                    flips.append(dict(training=training, seed=seed, version=version, point=i, share=float(share[i]),
                                      flagged=bool(flagged[i]), near=kinds(fa, i, bool(kink[i]))))
                if row["largest_unflagged"] > 1e-4 or row["largest_flagged"] > 1e-4 or seed == n:
                    rel, limit, ok = through_entry_points(model, tokens, coords, nwp, cor, version, primal, tang, n)
                    row.update(rel=rel, vapor_limit=limit, passes=ok)
                rows.append(row)
                print(json.dumps(row), flush=True)
        del state, model, tokens
        torch.cuda.empty_cache()
    for f in sorted(flips, key=lambda f: -f["share"])[:20]:
        print("[flip] " + json.dumps(f), flush=True)
    checked = [r for r in rows if "passes" in r]
    unflagged = [f for f in flips if not f["flagged"]]
    print(f"[summary] {len(rows)} point sets x versions of {args.points} points in {time.time() - t0:.0f} s, "
          f"bound window {bound_eps:g}; "
          f"one point's vapor term moved at most {np.nanmax([r['largest_unflagged'] for r in rows]):.3e} of the vapor sum "
          f"outside the switch set, {np.nanmax([r['largest_flagged'] for r in rows]):.3e} inside it (allowance at most "
          f"{np.nanmax([r['allowance'] for r in rows]):.3e}, median {float(np.nanmedian([r['allowance'] for r in rows])):.3e}; "
          f"{sum('non_finite' in r for r in rows)} sets with a non-finite term); "
          f"delta differs at {len(flips)} points, {len(unflagged)} of them outside the switch set (largest share "
          f"{max([f['share'] for f in unflagged], default=0.0):.3e}); through the entry points "
          f"{sum(not r['passes'] for r in checked)} of {len(checked)} sets fail the check", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
