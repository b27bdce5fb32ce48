"""The modules a run may not hold: JAX and the JAX package, by whole top-level name."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "deepphysinet_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Every loaded module whose top-level name is one of ``FORBIDDEN`` (``deepphysinet_tpu_torch``
    is not ``deepphysinet_tpu``)."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
