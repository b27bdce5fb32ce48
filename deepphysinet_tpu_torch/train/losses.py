"""Loss registry.

Counterpart of ``deepphysinet_tpu/train/losses.py``: pure functions
``loss(pred, target) -> scalar`` with mean reduction, accumulated in float32.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def mse_loss(**_) -> Loss:
    def loss(pred, target):
        d = pred.float() - target.float()
        return torch.mean(d * d)

    return loss


def l1_loss(**_) -> Loss:
    def loss(pred, target):
        return torch.mean(torch.abs(pred.float() - target.float()))

    return loss


def weight_smooth_l1_loss(beta: float = 0.1, **_) -> Loss:
    """Mean SmoothL1 with configurable beta (reference losses/weights_loss.py:12-20)."""

    def loss(pred, target):
        d = torch.abs(pred.float() - target.float())
        return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))

    return loss


def smooth_l1_loss(beta: float = 1.0, **_) -> Loss:
    return weight_smooth_l1_loss(beta=beta)


def cross_entropy_loss(**_) -> Loss:
    """Mean negative log-likelihood of ``logits`` [..., C] under integer class ``labels`` [...]
    or class probabilities [..., C]."""

    def loss(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        if labels.dim() == logits.dim() - 1:  # integer class labels
            nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        else:
            nll = -torch.sum(labels.float() * logp, dim=-1)
        return torch.mean(nll)

    return loss


LOSSES: Dict[str, Callable[..., Loss]] = {
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "WeightSmoothL1Loss": weight_smooth_l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "CrossEntropyLoss": cross_entropy_loss,
}


def build_loss(name: str, **kwargs) -> Loss:
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name](**kwargs)
