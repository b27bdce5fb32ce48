"""Model registry + builder: counterpart of ``deepphysinet_tpu/models/builder.py``
(reference model/builder.py:12-21).  Importing this module registers the port's
``PhysicsNet`` as ``"PhysicsNet"``."""

from __future__ import annotations

from deepphysinet_tpu_torch.models import physics_net  # noqa: F401  (registers "PhysicsNet")
from deepphysinet_tpu_torch.registry import MODELS


def build_model(name: str, **kwargs):
    return MODELS.build(name, **kwargs)
