"""The reference's grid frame: the six physical fields at every point of the label grid at one hour.

The NWP conditioning is interpolated in float64 from the window's NWP cube and rounded to
float32; the encoder and the decode run in the reference's precision; the inverse normalization
and the clip follow.
"""

from __future__ import annotations

from typing import Mapping

import torch

from benchmark.reference import model as M
from benchmark.reference import physics as P
from benchmark.reference.precision import Precision
from benchmark.reference.sampler import geometry, normalized, trilinear


@torch.no_grad()
def frame(params: Mapping[str, torch.Tensor], config: Mapping, window: Mapping, hour: float, prec: Precision,
          block: int = 16384) -> torch.Tensor:
    """-> [6, Hl * Wl] physical, row-major over (y, x)."""
    g = geometry(config)
    dev = window["field"].device
    with prec.active():
        fh = torch.tensor([[float(window["lead_h"]) / g.lead_period_h]], dtype=torch.float32, device=dev)
        tokens = M.encode(params, config, window["field"][None].float(), fh, prec)[0]
        layers = M.generated_layers(params, config, tokens, prec)
        ys, xs = torch.meshgrid(torch.arange(g.Hl, dtype=torch.float64, device=dev),
                                torch.arange(g.Wl, dtype=torch.float64, device=dev), indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
        hours = torch.full_like(xs, float(hour))
        nwp = trilinear(window["nwp_rows"].double(), g, g.lon0 + xs * g.fine_deg, g.lat0 + ys * g.fine_deg,
                        hours).float()
        coords = torch.stack([xs * g.dx, ys * g.dy, hours * 3600.0], dim=-1).float()
        outs = []
        for s in range(0, coords.shape[0], block):
            pe = M.coord_features(normalized(coords[s:s + block], g), config)
            out = M.decode(params, config, layers, pe, nwp[s:s + block], fh[0], prec)
            outs.append(P.to_physical(out, config))
        return torch.cat(outs).t().contiguous()
