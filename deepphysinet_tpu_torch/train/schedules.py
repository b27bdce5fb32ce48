"""Learning-rate schedules as pure functions ``epoch -> lr``.

Counterpart of ``deepphysinet_tpu/train/schedules.py``.  The reference steps its torch schedulers
once per epoch (interface_physics.py:831-837).  Here each schedule is a closed-form function of the
epoch index, and the trainer writes its value into the optimizer's parameter groups at the epoch
boundaries (``train/optim.py::set_learning_rate``), which gives torch's stepping exactly and lets a
resumed run start at the scheduled rate of its epoch.

Registry parity with the reference's utils/optims/builder.py:18-27:
  stepLR, CosineAnnealingLR, WarmupMultiStepLR, WarmupStepLR.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Sequence

from deepphysinet_tpu_torch.registry import LR_SCHEDULES

Schedule = Callable[[int], float]


@LR_SCHEDULES.register("stepLR")
def step_lr(lr: float, step_size: int, gamma: float = 0.1, **_) -> Schedule:
    def fn(epoch: int) -> float:
        return lr * gamma ** (epoch // step_size)

    return fn


@LR_SCHEDULES.register("CosineAnnealingLR")
def cosine_annealing_lr(lr: float, T_max: int, eta_min: float = 0.0, **_) -> Schedule:
    """Closed form of torch CosineAnnealingLR under once-per-epoch stepping."""

    def fn(epoch: int) -> float:
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2

    return fn


@LR_SCHEDULES.register("WarmupMultiStepLR")
def warmup_multi_step_lr(
    lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 3,
    warmup_iters: int = 100,
    warmup_method: str = "linear",
    **_,
) -> Schedule:
    """utils/optims/lr_schedule_utils.py:12-53."""
    milestones = list(milestones)
    if milestones != sorted(milestones):
        raise ValueError("Milestones should be increasing")

    def fn(epoch: int) -> float:
        wf = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = epoch / warmup_iters
                wf = warmup_factor * (1 - alpha) + alpha
        return lr * wf * gamma ** bisect_right(milestones, epoch)

    return fn


@LR_SCHEDULES.register("WarmupStepLR")
def warmup_step_lr(
    lr: float,
    start_epoch: int = 400,
    step_size: int = 200,
    step_gamma: float = 0.9,
    warmup_factor: float = 0.1,
    **_,
) -> Schedule:
    """utils/optims/lr_schedule_utils.py:55-147: linear ramp then stepped decay."""
    start_lr = lr * warmup_factor

    def fn(epoch: int) -> float:
        if epoch < start_epoch:
            return start_lr + (epoch / start_epoch) * (lr - start_lr)
        return lr * step_gamma ** ((epoch - start_epoch) // step_size)

    return fn


def build_lr_schedule(name: str = "stepLR", lr: float = 1e-3, **kwargs) -> Schedule:
    kwargs.pop("verbose", None)
    kwargs.pop("last_epoch", None)
    return LR_SCHEDULES.build(name, lr=lr, **kwargs)
