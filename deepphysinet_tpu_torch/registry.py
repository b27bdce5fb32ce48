"""Name -> factory registries: those of ``deepphysinet_tpu/registry.py`` that the port uses,
``MODELS`` (``models/physics_net.py``, built by ``models/builder.py``), ``DATASETS``
(``data/dataset.py``), ``PROJECTIONS`` (``utils/vis.py``), ``LR_SCHEDULES``
(``train/schedules.py``) and ``INTERFACES`` (``interface/interface_physics.py``), and
``BACKBONES`` (``models/backbone.py``), which JAX keeps in that module (backbone.py:21)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> factory mapping with decorator-style registration."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: Optional[str] = None, obj: Optional[Callable] = None):
        if obj is not None:  # direct call: REG.register('Name', fn)
            self._entries[name or obj.__name__] = obj
            return obj

        def deco(fn):
            self._entries[name or fn.__name__] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            raise KeyError(f"{self.name}: unknown entry {name!r}; available: {sorted(self._entries)}")
        return self._entries[name]

    def build(self, name: str, **kwargs) -> Any:
        return self.get(name)(**kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()


MODELS = Registry("models")
BACKBONES = Registry("backbones")
DATASETS = Registry("datasets")
PROJECTIONS = Registry("projections")
LR_SCHEDULES = Registry("lr_schedules")
INTERFACES = Registry("interfaces")
