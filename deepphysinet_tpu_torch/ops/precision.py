"""The JAX package's matmul precision rule, in one place.

JAX writes ``einsum(a.astype(cd), b.astype(cd), preferred_element_type=f32)``:
inputs rounded to the compute dtype, products and sums in float32, float32 out.
A bf16 ``torch.matmul`` would instead round its output to bf16, so the plain
PyTorch path rounds the inputs and multiplies in float32.  Products of two
bf16 values are exact in float32, so this equals a bf16 tensor-core product
with float32 accumulation up to summation order.  On a GPU, float32 matmuls
stay full precision only with ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default).
"""

from __future__ import annotations

import torch


def dot_f32(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both inputs rounded to ``compute_dtype``; float32 result."""
    return torch.matmul(a.to(compute_dtype).float(), b.to(compute_dtype).float())
