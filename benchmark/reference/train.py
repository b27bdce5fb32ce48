"""The reference's training steps: the loss, its gradient, the clip and Adam, in plain PyTorch.

loss = margin_factor * mean SmoothL1(beta)(decode(margin points), labels)      (normalized units)
     + sum_eq factor_eq * mean(residual_eq^2) at the margin points
     + sum_eq factor_eq * mean(residual_eq^2) at the collocation points

The derivatives along x, y and t of the physical fields come from forward mode
(``torch.func.jvp``, one pass a direction) through the whole decode; the parameter gradient from
reverse mode over that.  Every term is a sum over points, so the points go in blocks: each block's
share of the loss is taken back to the window's tokens and the decode's parameters, and the tokens'
gradient once through the encoder at the end.  The gradient is clipped to a global norm of
``CLIP_NORM``; Adam adds ``weight_decay * p`` to it before the moments (coupled L2).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from benchmark.reference import model as M
from benchmark.reference import physics as P
from benchmark.reference.precision import Precision
from benchmark.reference.sampler import Geometry, geometry, inter_points, margin_points, normalized

CLIP_NORM = 2.5e7
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _field_fn(params, config, layers, nwp, fh, g: Geometry, prec: Precision):
    def fn(coords):
        out = M.decode(params, config, layers, M.coord_features(normalized(coords, g), config), nwp, fh, prec)
        return out, P.to_physical(out, config)
    return fn


def _block_terms(params, config, layers, pts: Mapping, fh, g: Geometry, prec: Precision):
    """(normalized outputs [n, 6], residuals: six [n]) of one block of points."""
    fn = _field_fn(params, config, layers, pts["nwp"], fh, g, prec)
    coords = pts["coords"]
    tangents = []
    for axis in range(3):
        basis = torch.zeros_like(coords)
        basis[:, axis] = 1.0
        (out, phys), (_, d_phys) = torch.func.jvp(fn, (coords,), (basis,))
        tangents.append(d_phys)
    return out, P.residuals(phys, *tangents, pts["f"])


def loss_and_grads(params: Dict[str, torch.Tensor], config: Mapping, window: Mapping, draws: Mapping,
                   prec: Precision, block: int = 8192, fields: Optional[List] = None) -> Dict[str, float]:
    """One step's loss terms under the measured program's metric names (``margin_loss``, the six
    ``margin_*`` and ``inter_*`` residual terms, ``total_loss``); the gradient lands in each
    parameter's ``.grad``.  With ``fields``, the decoded fields at the labelled points, normalized,
    are appended to it a block at a time."""
    g = geometry(config)
    fac = P.factors(config)
    beta = float(config["train_cfg"]["losses"]["prediction_loss"].get("beta", 0.1))
    for p in params.values():
        p.grad = None
    fh = torch.tensor([[float(window["lead_h"]) / g.lead_period_h]], dtype=torch.float32,
                      device=window["field"].device)
    tokens = M.encode(params, config, window["field"][None].float(), fh, prec)[0]
    tok = tokens.detach().requires_grad_(True)
    terms: Dict[str, float] = {}
    for kind, pts_all in (("margin", margin_points(window, draws, g)), ("inter", inter_points(window, draws, g))):
        n = pts_all["coords"].shape[0]
        for s in range(0, n, block):
            pts = {k: v[s:s + block] for k, v in pts_all.items()}
            layers = M.generated_layers(params, config, tok, prec)
            out, res = _block_terms(params, config, layers, pts, fh[0], g, prec)
            parts = {f"{kind}_{t}": fac[f] * (r.float() * r.float()).sum() / n
                     for t, f, r in zip(P.TERMS, P.FACTORS, res)}
            if kind == "margin":
                if fields is not None:
                    fields.append(out.detach())
                parts["margin_loss"] = fac["margin_factor"] * P.smooth_l1_sum(out, pts["labels"], beta) / (6 * n)
            sum(parts.values()).backward()
            for k, v in parts.items():
                terms[k] = terms.get(k, 0.0) + float(v.detach())
    tokens.backward(tok.grad)
    terms["total_loss"] = sum(terms.values())
    return terms


class Adam:
    """Adam with coupled L2, as the configuration's optimizer; state by parameter name."""

    def __init__(self, lr: float, weight_decay: float):
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip, update in place; returns the gradient as the moments received it."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = torch.clamp(CLIP_NORM / (norm + 1e-6), max=1.0)
        self.t += 1
        b1, b2 = BETAS
        seen = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * scale + self.wd * p
                seen[k] = g
                m = self.m.setdefault(k, torch.zeros_like(p))
                v = self.v.setdefault(k, torch.zeros_like(p))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v.sqrt() / (1 - b2 ** self.t) ** 0.5 + ADAM_EPS
                p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))
        return seen


def run_steps(params0: Mapping[str, torch.Tensor], config: Mapping, windows: List[Mapping],
              draws: List[Mapping], prec: Precision, block: int = 8192, device: Optional[torch.device] = None):
    """The first ``len(draws)`` steps from ``params0``, step i on ``windows[i]`` with ``draws[i]``.

    Returns ``losses`` (one a step), ``terms`` (each step's loss terms), ``fields1`` (the first
    step's decoded fields at its labelled points [N, 6]), ``grad`` (the first step's gradient as Adam
    received it),
    ``raw_grad_norms`` (the first step's loss gradient a leaf) and ``params`` (after the last)."""
    opt_cfg = config["train_cfg"]["optimizer"]
    adam = Adam(float(opt_cfg["lr"]), float(opt_cfg.get("weight_decay", 0.0)))
    params = {k: v.detach().to(device or v.device, torch.float32).clone().requires_grad_(True)
              for k, v in params0.items()}
    terms, first, raw, fields = [], None, None, []
    with prec.active():
        for w, d in zip(windows, draws):
            terms.append(loss_and_grads(params, config, w, d, prec, block, fields if first is None else None))
            if first is None:
                raw = {k: float(torch.linalg.vector_norm(p.grad)) if p.grad is not None else 0.0
                       for k, p in params.items()}
            seen = adam.step(params)
            if first is None:
                first = {k: g.detach().clone() for k, g in seen.items()}
    return dict(losses=[t["total_loss"] for t in terms], terms=terms, fields1=torch.cat(fields), grad=first,
                raw_grad_norms=raw,
                params={k: p.detach() for k, p in params.items()})
