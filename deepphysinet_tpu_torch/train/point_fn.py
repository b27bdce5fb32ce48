"""Inverse normalization of stacked model outputs.

Counterpart of ``inverse_norm_stack`` and ``inverse_norm_stack_t`` in
``deepphysinet_tpu/train/point_fn.py`` (:32-63): u and v are never clipped; P, T, q and rho clip to their bounds when
``with_clip`` (reference interface_physics.py:256-261).
"""

from __future__ import annotations

from typing import Sequence

import torch

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
