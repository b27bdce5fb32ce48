"""Interface registry lookup: the port's ``deepphysinet_tpu/interface/build.py`` (reference
interface/build.py:11-20)."""

from __future__ import annotations

from deepphysinet_tpu_torch.registry import INTERFACES


def builder_models(name: str = "InterfacePhysics", **kwargs):
    """The interface registered as ``name``, built from the configuration's sections (and
    ``device``)."""
    from deepphysinet_tpu_torch.interface import interface_physics  # noqa: F401  (registers it)

    return INTERFACES.build(name, **kwargs)
