"""Optimizers.

Counterpart of ``deepphysinet_tpu/train/optim.py``.  The JAX package rebuilds
the reference's torch optimizers on optax: ``Adam`` with ``weight_decay`` adds
``wd * param`` to the gradient before the moment updates (coupled L2, not
AdamW).  That is ``torch.optim.Adam(weight_decay=...)`` itself, so the port
builds the torch optimizer directly.
"""

from __future__ import annotations

import torch


def build_optimizer(name: str = "Adam", *, params, lr: float = 1e-3, weight_decay: float = 0.0,
                    betas=(0.9, 0.999), eps: float = 1e-8, momentum: float = 0.0,
                    **_) -> torch.optim.Optimizer:
    """``params`` is an iterable of parameters, e.g. ``model.parameters()``."""
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                                weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    raise KeyError(f"unknown optimizer {name!r}; available: ['Adam', 'SGD']")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group (trainer epoch boundary)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer
