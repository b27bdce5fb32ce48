"""Variable normalization and its inverse.

Counterpart of ``deepphysinet_tpu/ops/normalization.py``: the forward map
``normalize`` (reference dataset/physics_dataset.py:270-290) and the inverse of
model outputs to physical units (reference interface/interface_physics.py:234-254),
including the optional clip to physical bounds.
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


def _as_arrays(norm_factor) -> Tuple[np.ndarray, ...]:
    """The factors as float32 arrays (a factor may be a vector: pressure-level stacks)."""
    if isinstance(norm_factor, (int, float)):
        return (np.float32(norm_factor),)
    return tuple(np.asarray(f, dtype=np.float32) for f in norm_factor)


def normalize(data: torch.Tensor, spec: NormSpec) -> torch.Tensor:
    """Forward normalization (JAX normalization.py:51-67): ``mean_norm`` (x - mean) / std;
    ``min_max`` with 2 factors (x - min) / (max - min), with 1 x / factor, with 3
    (sqrt(x - min) - a_min) / (a_max - a_min).  Float32 factors, differences of factors
    taken in float32, and the result at least float32, as JAX promotes it."""
    if not spec.use_norm:
        return data
    data = data.to(torch.promote_types(data.dtype, torch.float32))

    def t(f):
        return torch.as_tensor(f, device=data.device)

    if spec.norm_type.lower() == "min_max":
        fs = _as_arrays(spec.norm_factor)
        if len(fs) == 2:
            lo, hi = fs
            return (data - t(lo)) / t(hi - lo)
        if len(fs) == 1:
            return data / t(fs[0])
        if len(fs) == 3:
            a_min, a_max, lo = fs
            return (torch.sqrt(data - t(lo)) - t(a_min)) / t(a_max - a_min)
        raise NotImplementedError(f"min_max with {len(fs)} factors")
    mean, std = _as_arrays(spec.norm_factor)
    return (data - t(mean)) / t(std)


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
