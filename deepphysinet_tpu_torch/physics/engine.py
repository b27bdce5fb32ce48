"""Decode engine: the forward-only collapsed decode used by inference.

Counterpart of ``_kernel_inputs`` (:351-364, without the tangent input
``dpe``) and ``collapsed_decode_t`` (:578-611) of
``deepphysinet_tpu/physics/engine.py``.  The JAX package ships the XLA twin
there because its Pallas kernel measured slower on the TPU; the port always
calls ``decode_primal_v4t``, which launches the Hopper kernel whenever the
tensors are on a GPU.
"""

from __future__ import annotations

import torch

from deepphysinet_tpu_torch.ops.decode_kernel import (
    decode_primal_v4t, extract_decode_weights, fuse_decode_weights, pe_primal)
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe_flat


def _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec):
    """Per-window decode weights plus the compute-dtype PE inputs of the points."""
    weights = extract_decode_weights(model, tokens, fore_h)
    pe = pe_primal(coords, coord_spec, dtype=model.compute_dtype)
    in_ch = model.net_cfg["in_channels"]
    cd_freqs = make_freq_bands(in_ch // 2 // 6, max_freq=4.0)
    cd_pe = sinecos_pe_flat(coord_data, cd_freqs, dtype=model.compute_dtype)
    return weights, pe, cd_pe


@torch.no_grad()
def collapsed_decode_t(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
) -> torch.Tensor:
    """Var-major normalized primal decode [6, N] via the collapsed v4 algebra."""
    weights, pe, cd_pe = _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec)
    fw = fuse_decode_weights(weights)
    ref_t = coord_data.float().t().contiguous()
    return decode_primal_v4t(fw, pe, cd_pe, ref_t, compute_dtype=model.compute_dtype)
