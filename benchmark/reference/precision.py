"""The precision of the plain reference's matrix products.

The reference computes every product through ``Precision.mm``:

* ``float32``: full float32 (TF32 off for matmuls and convolutions): the reference itself;
* ``tf32``: TF32 on, the control of a float32 configuration;
* ``fp8``: the control of a bfloat16 configuration.  Every tensor that enters or leaves a product
  is rounded to float8 e4m3 with one scale a tensor (its largest magnitude mapped to e4m3's
  largest, 448): both operands and the result in the forward pass, their forward-mode tangents
  likewise, and in the backward pass the gradient arriving at the result and the gradients it
  hands to the operands.  The sums inside a product stay float32.  So the activations, the
  generated weights, the tangents along x, y and t and the backward's intermediates are held in
  e4m3 wherever the bfloat16 program holds them in bfloat16.

Everything between the products (norms, softmax, the activations' functions, the physics) stays
float32 in every mode.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
MODES = ("float32", "tf32", "fp8")


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Round(torch.autograd.Function):
    """e4m3 rounding whose gradient and tangent are rounded as well."""

    @staticmethod
    def forward(x):
        return _e4m3(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return _Round.apply(grad)

    @staticmethod
    def jvp(ctx, tangent):
        return _Round.apply(tangent)


class Precision:
    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown reference precision {mode!r}; expected one of {MODES}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Round.apply(torch.matmul(_Round.apply(a), _Round.apply(b)))
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self):
        """The TF32 switches for the duration of a reference computation."""
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
