"""Initializers matching the reference's torch defaults, from an explicit generator.

Counterpart of ``deepphysinet_tpu/models/init.py``: uniform +-1/sqrt(fan_in)
for dense kernels and biases, kaiming-normal (leaky_relu gain) for the token
convolution, U[0, 1) for the learnable tokens.  Draws are made on the CPU from
the caller's ``torch.Generator`` and copied to each parameter's device, so a
seed gives the same weights on every device.  They differ from ``jax.random``
draws; tests move weights between the packages with ``state_dict_from_jax``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t = torch.rand(param.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        param.copy_((2.0 * t - 1.0) * bound)


def normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t = torch.randn(param.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        param.copy_(t * std)


def kaiming_normal_std(fan_in: int) -> float:
    """fan_in mode, leaky_relu(0.01) gain (reference model/embed.py:43-45)."""
    return math.sqrt(2.0 / (1.0 + 0.01**2)) / math.sqrt(fan_in)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``generator``, in module order."""
    for module in model.modules():
        if hasattr(module, "reset_parameters_from"):
            module.reset_parameters_from(generator)
        elif isinstance(module, nn.LayerNorm):
            with torch.no_grad():
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model
