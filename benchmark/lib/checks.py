"""The numbers that decide ``correct``, each held to a limit of its own (``limits/<workload>.json``).

Training (the first steps of the object the window drives, against the reference's):

* ``batch_gap``: the widest gap, over every point that the steps drew, between the batch that
  the program's step consumed and the reference's points worked out from the same cubes and
  draws: coordinates over the domain's extent, the Coriolis parameter over 2 Omega, the NWP
  conditioning and the labels in normalization scales.  A point that the program's batch lacks
  is compared as zeros, so a missing or moved point reads a gap of order 1;
* ``field1_gap``: the widest gap, over every labelled point of the first step, between the six
  fields that the program's step decoded there (normalized, as its loss takes them) and the
  reference's, in normalization scales; a point the program lacks compared as zeros;
* ``loss_gap``: the largest |program - reference| / |reference| of the steps' total losses, and
  ``loss1_gap`` the first step's;
* ``pde_term1_gap``: the largest relative gap of the first step's twelve residual terms (six
  equations at the margin and at the collocation points), and ``pde1_gap`` that of their sum;
* ``grad_gap``: the first step's gradient as Adam received it (its first moment after one step
  over 1 - beta1; the clipped gradient plus the coupled L2 term), by the worst leaf: the gap
  between the program's norm of the leaf and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; ``grad_median_gap`` the median leaf's gap;
* ``change_gap``: the change of the parameters over the steps, by the worst leaf in the same way,
  leaving out the leaves whose reference gradient in the first step is under ``NOUGHT_SHARE`` of
  the median leaf's (a key projection's bias under softmax: Adam moves it by round-off alone);
  ``change_median_gap`` the median leaf's.

Every number is reported; those named in the cell's limits file are compared.

Frames: ``field_gap``, the widest gap over every point and variable of the sampled frames between
the program's physical field and the reference's, in units of the variable's normalization
scale.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Optional, Tuple

import torch

NOUGHT_SHARE = 1e-3


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    g, w = leaf_norms({k: got[k] for k in names}), leaf_norms({k: want[k] for k in names})
    med = statistics.median(w.values())
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in names}


def _worst_and_median(gaps: Mapping[str, float], name: str) -> Dict[str, Dict]:
    leaf = max(gaps, key=gaps.get)
    return {name: dict(value=gaps[leaf], leaf=leaf),
            name.replace("_gap", "_median_gap"): dict(value=statistics.median(gaps.values()))}


def moved_leaves(raw_grad_norms: Mapping[str, float]) -> List[str]:
    med = statistics.median(raw_grad_norms.values())
    return [k for k, v in raw_grad_norms.items() if v >= NOUGHT_SHARE * med]


def training_numbers(prog: Mapping, ref: Mapping, params0: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """``prog`` / ``ref``: losses [steps], grad {name: tensor}, params {name: tensor} after the
    steps; ``ref`` also raw_grad_norms.  -> {name: {value, leaf}}."""
    losses = [relative_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    dev = next(iter(ref["params"].values())).device
    change_p = {k: prog["params"][k].to(dev) - params0[k].to(dev) for k in ref["params"]}
    change_r = {k: ref["params"][k] - params0[k].to(dev) for k in ref["params"]}
    out = dict(loss_gap=dict(value=max(losses)), loss1_gap=dict(value=losses[0]))
    t_p, t_r = prog["terms"][0], ref["terms"][0]
    pde = [k for k in t_r if k.startswith(("margin_", "inter_")) and k != "margin_loss"]
    term_gaps = {k: relative_gap(t_p[k], t_r[k]) for k in pde}
    worst = max(term_gaps, key=term_gaps.get)
    out["pde_term1_gap"] = dict(value=term_gaps[worst], term=worst)
    out["pde1_gap"] = dict(value=relative_gap(sum(t_p[k] for k in pde), sum(t_r[k] for k in pde)))
    if "fields1" in prog:
        out["field1_gap"] = dict(value=batch_gap([dict(margin=prog["fields1"])], [dict(margin=ref["fields1"])]))
    out.update(_worst_and_median(leaf_gaps(prog["grad"], ref["grad"]), "grad_gap"))
    out.update(_worst_and_median(leaf_gaps(change_p, change_r, keep=moved_leaves(ref["raw_grad_norms"])),
                                 "change_gap"))
    return out


def batch_gap(got: List[Mapping[str, torch.Tensor]], want: List[Mapping[str, torch.Tensor]]) -> float:
    """got / want: one {group: [N, columns]} a step; rows the program lacks compare as zeros."""
    gap = 0.0
    for g_step, w_step in zip(got, want):
        for group, w in w_step.items():
            g = g_step[group].to(w.device, torch.float32)
            n = max(g.shape[0], w.shape[0])
            g = torch.nn.functional.pad(g, (0, 0, 0, n - g.shape[0]))
            w = torch.nn.functional.pad(w.float(), (0, 0, 0, n - w.shape[0]))
            gap = max(gap, float((g - w).abs().max()))
    return gap if len(got) == len(want) else float("inf")


def field_gap(got: torch.Tensor, want: torch.Tensor, std: torch.Tensor) -> float:
    """got / want [6, N] physical, std [6]."""
    return float(((got.float() - want.float()).abs() / std[:, None]).max())


def judge(numbers: Mapping[str, Mapping], limits: Mapping[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """Each number that has a limit beside it; correct when every one is within its limit.  A
    limit whose number the cell's kind did not give fails."""
    out = {name: dict(value=float(numbers[name]["value"]) if name in numbers else float("inf"), limit=float(lim))
           for name, lim in limits.items()}
    ok = bool(out) and all(row["value"] <= row["limit"] for row in out.values())
    return ok, out
