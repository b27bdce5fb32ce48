"""Inverse normalization of model outputs to physical units.

Counterpart of ``deepphysinet_tpu/ops/normalization.py`` (reference
interface/interface_physics.py:234-254), including the optional clip to
physical bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NormSpec:
    """One variable's normalization config (configs/DeepPhysiNet_NCEP_cfg.py:36-83)."""

    name: str
    norm_type: str = "mean_norm"
    norm_factor: Tuple = (0.0, 1.0)
    use_norm: bool = True
    bound: Optional[Tuple[float, float]] = None


def _as_floats(norm_factor) -> Tuple[float, ...]:
    """Scalar factors, rounded to float32 as the JAX package holds them."""
    if isinstance(norm_factor, (int, float)):
        return (float(np.float32(norm_factor)),)
    return tuple(float(np.float32(f)) for f in norm_factor)


def inverse_normalize(data: torch.Tensor, spec: NormSpec, with_clip: bool = False) -> torch.Tensor:
    """Inverse normalization, matching interface/interface_physics.py:234-254."""
    if not spec.use_norm:
        return data
    if spec.norm_type.lower() == "min_max":
        fs = _as_floats(spec.norm_factor)
        if len(fs) == 2:
            lo, hi = fs
            data = data * float(np.float32(hi - lo)) + lo
        else:
            a_min, a_max, lo = fs
            data = data * float(np.float32(a_max - a_min)) + a_min
            data = data**2 + lo
    else:
        mean, std = _as_floats(spec.norm_factor)
        data = data * std + mean
    if with_clip and spec.bound is not None:
        data = torch.clamp(data, float(spec.bound[0]), float(spec.bound[1]))
    return data


def norm_specs_from_cfg(variable_cfg: Dict[str, dict]) -> Dict[str, NormSpec]:
    """Hydrate NormSpecs from a reference-schema variable_cfg / obs_norm_cfg dict."""

    def _freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(_freeze(x) for x in v)
        return v

    out = {}
    for key, sub in variable_cfg.items():
        out[key] = NormSpec(
            name=sub.get("name", key),
            norm_type=sub.get("norm_type", "mean_norm"),
            norm_factor=_freeze(sub.get("norm_factor", (0.0, 1.0))),
            use_norm=sub.get("use_norm", True),
            bound=_freeze(sub.get("bound")) if sub.get("bound") is not None else None,
        )
    return out


# Order in which observation variables are stacked everywhere
# (reference dataset/physics_dataset.py:31 ``obs_name_order``).
OBS_NAME_ORDER = ("u10", "v10", "pres", "t2", "q2", "rio")
