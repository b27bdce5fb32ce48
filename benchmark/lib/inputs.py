"""Everything a run feeds the program, made from ``--seed`` on the device in a few large calls.

* Weights: every parameter of the reference's list (``reference/model.py::param_specs``) at the
  scales of PyTorch's defaults, as the paper's code initializes them: dense weights and biases
  uniform +-1/sqrt(fan_in), the token convolution kaiming-normal (leaky_relu(0.01) gain),
  the learnable tokens U[0, 1), LayerNorm weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1) (so that
  no norm is the identity); each variable net's head (``out_fc``) scaled by ``HEAD_SCALE``, so
  that the fields start near their NWP prior, as after the data-only steps that precede the PDE
  terms: with the default head the decode's outputs spread over tens of normalization scales, most
  densities sit on their clip floor, and the loss is carried by 1/rho at the few points just above
  it, where a rounding moves it by percent.  float32, the type the program keeps its parameters in.
* Windows, as ``data/synthetic.py`` of the measured package draws them: the token matrix's NWP
  rows N(0, 1) and its constant rows U[0, 1); the NWP cube and the label cube 0.5 N(0, 1),
  channel-last row tables; the lead time from the traffic's list.
* Draws, one step's: margin points uniform on the label grid (x, y, hour), collocation points
  uniform in the box at whole hours, as the trainer's device sampler draws them.

Each stream has its own ``torch.Generator`` on the device, seeded from the run's seed and the
stream's number, so that one stream's sizes never move another's values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from benchmark.reference.model import param_specs, sizes
from benchmark.reference.sampler import geometry

WEIGHTS, WINDOWS, DRAWS, SAMPLE = 1, 2, 3, 4
HEAD_SCALE = 0.01


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (2 ** 62))
    return g


def weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = param_specs(config)
    total = sum(math.prod(shape) for shape, _, _ in specs.values())
    gen = generator(seed, WEIGHTS, device)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind, fan_in) in specs.items():
        n = math.prod(shape)
        u, z = uni[at:at + n].view(shape), nrm[at:at + n].view(shape)
        at += n
        if kind == "dense":
            out[name] = (2.0 * u - 1.0) / math.sqrt(fan_in) * (HEAD_SCALE if ".out_fc." in name else 1.0)
        elif kind == "conv":
            out[name] = z * (math.sqrt(2.0 / (1.0 + 0.01 ** 2)) / math.sqrt(fan_in))
        elif kind == "token":
            out[name] = u.clone()
        elif kind == "ln_w":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def windows(config: Mapping, traffic: Mapping, seed: int, device, labels: bool = True) -> List[Dict]:
    """``traffic['windows']`` windows: field [L, enc_in], nwp_rows [Hc Wc Tc, 6], label_rows
    [Hl Wl Tl, 6] (when ``labels``), lead_h."""
    s, g = sizes(config), geometry(config)
    n_const = len(config["train_cfg"]["train_data"].get("constant_variables", ()))
    L, C = s["token_num"], s["enc_in"]
    n = int(traffic["windows"])
    Xc, Xl = g.Hc * g.Wc * g.Tc, g.Hl * g.Wl * g.Tl
    gen = generator(seed, WINDOWS, device)
    nrm = torch.randn(n, (L - n_const) * C + Xc * 6 + (Xl * 6 if labels else 0), generator=gen, device=device)
    const = torch.rand(n, n_const * C, generator=gen, device=device)
    leads = [float(h) for h in traffic["leads_h"]]
    out = []
    for w in range(n):
        a = (L - n_const) * C
        field = torch.cat([nrm[w, :a].view(L - n_const, C), const[w].view(n_const, C)])
        win = dict(field=field, nwp_rows=0.5 * nrm[w, a:a + Xc * 6].view(Xc, 6), lead_h=leads[w % len(leads)])
        if labels:
            win["label_rows"] = 0.5 * nrm[w, a + Xc * 6:].view(Xl, 6)
        out.append(win)
    return out


class DrawStream:
    """One step's draws after another, for one window a step."""

    def __init__(self, config: Mapping, n_margin: int, n_inter: int, seed: int, device):
        self.g = geometry(config)
        self.nm, self.ni = int(n_margin), int(n_inter)
        self.gen = generator(seed, DRAWS, device)
        self.device = device

    def next(self) -> Dict[str, torch.Tensor]:
        g, kw = self.g, dict(generator=self.gen, device=self.device)
        return dict(mx=torch.randint(0, g.Wl, (self.nm,), **kw), my=torch.randint(0, g.Hl, (self.nm,), **kw),
                    slot=torch.randint(0, g.Tl, (self.nm,), **kw),
                    off=torch.randint(0, g.Hl * g.Wl * g.Tl, (1,), **kw)[0],
                    ix=torch.rand(self.ni, **kw), iy=torch.rand(self.ni, **kw),
                    it=torch.randint(0, g.window_h + 1, (self.ni,), **kw))
