"""Full softmax attention: the plain path of ``deepphysinet_tpu/ops/attention.py``.

The JAX package sends sequences of up to 1024 tokens to ``attention_xla``
(ops/attention.py:181-189); the flagship encoder has 287, so this is the path
the port needs.  Scores and softmax run in float32 and the probabilities are
rounded to ``v``'s dtype before the second product, as in attention_xla
(:40-45).  The Pallas kernels for longer sequences are not ported yet.
"""

from __future__ import annotations

import torch

from deepphysinet_tpu_torch.ops.precision import dot_f32


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v: [B, L, H, E] -> [B, L, H, E] in ``v``'s dtype (no mask)."""
    cd = v.dtype
    scores = dot_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1), cd)  # [B, H, L, S]
    a = torch.softmax(scale * scores, dim=-1)
    out = dot_f32(a, v.permute(0, 2, 1, 3), cd)  # [B, H, L, E]
    return out.to(cd).permute(0, 2, 1, 3)
