"""Python-file config loader (the port's own copy of
``deepphysinet_tpu/config/config.py``, so that the port imports nothing of the
JAX package).

The reference drives everything from a single mmcv-style Python config file: a
module defining nested dicts, loaded with ``mmcv.Config.fromfile`` (train.py:37)
and splatted into the interface constructor (interface/build.py:16-18).  mmcv is
not a dependency here; ``Config.fromfile`` execs the file and collects its
module-level names, so the exact same config files load unchanged
(configs/DeepPhysiNet_NCEP_cfg.py:11-233 schema).
"""

from __future__ import annotations

import copy
import importlib.util
import os
import types
from typing import Any, Dict


class Config(dict):
    """A dict with attribute access and ``fromfile``, mirroring mmcv.Config usage."""

    def __getattr__(self, key: str) -> Any:
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[key] = value
        return value

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def fromfile(path: str) -> "Config":
        path = os.path.abspath(os.path.expanduser(path))
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location("_dpn_config", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)  # type: ignore[union-attr]
        out = Config()
        for name in dir(module):
            if name.startswith("__"):
                continue
            value = getattr(module, name)
            if isinstance(value, (types.ModuleType, types.FunctionType, type)):
                continue
            out[name] = copy.deepcopy(value)
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))


def load_config(path: str) -> Config:
    return Config.fromfile(path)


def update_params(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive key override, the equivalent of utils/utils.py:69-86.

    Keys may address nested dicts with dots: ``train_cfg.optimizer.lr``.
    """
    for key, value in overrides.items():
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        leaf = parts[-1]
        if isinstance(value, dict) and isinstance(node.get(leaf), dict):
            update_params(node[leaf], value)
        else:
            node[leaf] = value
    return cfg
