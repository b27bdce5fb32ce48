"""The device the port's entry points run on.

Every entry point (``PhysicsNet``, ``create_train_state``, ``batch_to_device``,
``predict_grid`` / ``predict_points``, the sweeps of ``eval/``) takes ``device=None`` and resolves it
here: the first CUDA device, or an error.  There is no fallback to the CPU; a
caller that wants the CPU (the parity tests do) passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device() -> torch.device:
    """``cuda:0``; raises when CUDA is not available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "deepphysinet_tpu_torch runs on an NVIDIA GPU and CUDA is not available; "
            "pass device=\"cpu\" explicitly to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def model_device(model: torch.nn.Module, device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device of a run on ``device`` (``None``: ``default_device()``), which
    the model must already be on; the model's own device is returned."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type or (device.index is not None
                                            and param.device.index != device.index):
        raise ValueError(f"the model is on {param.device}, the run on {device}")
    return param.device
