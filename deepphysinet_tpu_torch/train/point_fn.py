"""Inverse normalization of stacked model outputs, and the differentiable point function.

Counterpart of ``deepphysinet_tpu/train/point_fn.py``: ``inverse_norm_stack``
and ``inverse_norm_stack_t`` (:32-63; u and v are never clipped; P, T, q and
rho clip to their bounds when ``with_clip``, reference
interface_physics.py:256-261) and ``make_phys_fn`` (:66), the function that the
``'linearize'`` engine differentiates: physical coordinates in, physical
fields out, for one window.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from deepphysinet_tpu_torch.ops.coords import CoordSpec, encode_coord
from deepphysinet_tpu_torch.ops.normalization import NormSpec, inverse_normalize

# obs_norm_cfg keys in output-row order
_CLIPPED = (False, False, True, True, True, True)  # u, v never clip


def inverse_norm_stack(out_norm: torch.Tensor, obs_specs: Sequence[NormSpec],
                       with_clip: bool) -> torch.Tensor:
    """[N, 6] normalized outputs -> [N, 6] physical."""
    cols = [inverse_normalize(out_norm[:, i : i + 1], spec, with_clip=with_clip and _CLIPPED[i])
            for i, spec in enumerate(obs_specs)]
    return torch.cat(cols, dim=-1)


def inverse_norm_stack_t(out_norm_t: torch.Tensor, obs_specs: Sequence[NormSpec],
                         with_clip: bool) -> torch.Tensor:
    """[6, N] normalized var-major outputs -> [6, N] physical."""
    rows = [inverse_normalize(out_norm_t[i : i + 1, :], spec, with_clip=with_clip and _CLIPPED[i])
            for i, spec in enumerate(obs_specs)]
    return torch.cat(rows, dim=0)


def make_phys_fn(model, tokens: torch.Tensor, coord_data: torch.Tensor, fore_h: torch.Tensor,
                 coord_spec: CoordSpec, obs_specs: Sequence[NormSpec],
                 with_clip: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """``phys_fn([N, 3] physical x, y, t) -> [N, 6] physical fields`` of one window.

    Coordinate encoding, the plain per-variable decode and the inverse
    normalization.  The conditioning values ``coord_data`` [N, 6] are constants
    under differentiation (detached), as in the reference, where they are
    dataloader outputs with no graph attached."""
    coord_data = coord_data.detach()

    def phys_fn(coords: torch.Tensor) -> torch.Tensor:
        pe = encode_coord(coords[:, 0], coords[:, 1], coords[:, 2], coord_spec)
        out_norm = model.decode(tokens, pe, coord_data, fore_h)
        return inverse_norm_stack(out_norm, obs_specs, with_clip)

    return phys_fn
