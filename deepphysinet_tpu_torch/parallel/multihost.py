"""The process group of a data-parallel run: one process a GPU, started by ``torchrun``.

Counterpart of ``deepphysinet_tpu/parallel/multihost.py``.  Where the JAX package joins
``jax.distributed`` and lets one controller drive a mesh of chips, the port runs one process a card,
as the reference's DDP path does: ``torchrun`` (``python -m torch.distributed.run``) starts them and
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``initialize_distributed`` joins the group from those and returns the rank's device.

* The backend is NCCL unless the caller names another; a failed NCCL start raises, never falls back.
* The device is ``cuda:LOCAL_RANK``.  A node with fewer cards than ranks is an error, unless the
  caller names the ``gloo`` backend, which may put several ranks on one card (``cuda:LOCAL_RANK %
  cards``).  ``device="cpu"`` runs the ranks on the CPU, over gloo only.
* Without a launcher's environment (no ``WORLD_SIZE``) the run is one process and joins no group,
  as the JAX function is a no-op on one host; an initialised group is kept as it is.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def world_size() -> int:
    """The number of ranks of the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(local_rank: int, backend: str, n_cards: int,
                 device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of the rank ``local_rank`` of its node: ``cuda:local_rank`` on a node of ``n_cards``
    cards; several ranks share a card only over gloo, named by the caller; ``device="cpu"`` keeps
    the rank on the CPU (gloo only)."""
    backend = backend.lower()
    if device is not None and torch.device(device).type == "cpu":
        if backend != "gloo":
            raise ValueError(f"ranks on the CPU need the gloo backend, not {backend!r}")
        return torch.device("cpu")
    if n_cards < 1:
        raise RuntimeError("a data-parallel run on the GPU needs CUDA, and none is available; pass "
                           "--device cpu with --dist_backend gloo to run the ranks on the CPU")
    if local_rank >= n_cards:
        if backend != "gloo":
            raise RuntimeError(f"local rank {local_rank} has no card of its own ({n_cards} on this node); "
                               f"start at most {n_cards} ranks a node, or name the gloo backend "
                               "(--dist_backend gloo) to share cards")
        return torch.device("cuda", local_rank % n_cards)
    return torch.device("cuda", local_rank)


def initialize_distributed(backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes and return this rank's device.

    ``backend`` defaults to ``"nccl"``.  Without ``WORLD_SIZE`` in the environment this is one process:
    no group is joined, and the device is ``device`` (``None``: ``cuda:0``).  An initialised group is
    kept; the device is still the rank's."""
    backend = (backend or "nccl").lower()
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        from deepphysinet_tpu_torch.device import resolve_device

        return resolve_device(device)
    dev = local_device(local_rank, backend, n_cards, device)
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend)
    return dev


def process_shard(n_items: int) -> range:
    """This rank's items of a dataset's index (``DistributedSampler``'s stride)."""
    return range(rank(), n_items, world_size())


def all_ranks_max(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any (one all-reduce); the flag itself alone."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)
