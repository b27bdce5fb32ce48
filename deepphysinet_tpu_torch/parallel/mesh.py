"""Each rank's place on the (data, points) mesh, and its share of a batch.

Counterpart of ``deepphysinet_tpu/parallel/mesh.py``.  The JAX mesh has two axes:

* ``data``: one window a slot (the reference's ``DistributedSampler``): field tokens and point
  batches split their leading window axis over it;
* ``points``: an optional second axis that splits each window's points into equal contiguous chunks.

The port runs one process a rank, so the mesh is the ranks laid out row-major as JAX lays out its
devices (``reshape(data, points)``): rank r sits at ``(r // points, r % points)``.  The ranks of one
data slot load the same windows, each takes its chunk of their points, and the steps of
``parallel/sharding.py`` average the gradients and metrics over every rank, the all-axes ``pmean`` of
JAX.  All collectives run on the world's group; the mesh needs no group of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepphysinet_tpu_torch.parallel import multihost
from deepphysinet_tpu_torch.train.train_step import Batch, PointBatch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: the world divided by ``points``
    points: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of ``data`` x ``points`` ranks and this rank's coordinate on it."""

    data: int
    points: int
    rank: int

    @property
    def data_index(self) -> int:
        return self.rank // self.points

    @property
    def points_index(self) -> int:
        return self.rank % self.points

    @property
    def shape(self) -> dict:
        return {"data": self.data, "points": self.points}


def make_mesh(cfg: MeshConfig = MeshConfig(), world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The mesh over ``world`` ranks (default: the process group's), ``data=-1`` read as JAX reads it:
    the world divided by ``points``.  Every rank must have a place: ``data * points`` is the world."""
    world = multihost.world_size() if world is None else int(world)
    rank = multihost.rank() if rank is None else int(rank)
    points = max(1, int(cfg.points))
    data = int(cfg.data) if cfg.data > 0 else world // points
    if data < 1 or data * points != world:
        raise ValueError(f"mesh data={cfg.data} x points={cfg.points} does not cover the {world} ranks "
                         "(each rank holds one slot)")
    return Mesh(data=data, points=points, rank=rank)


def point_chunk(points: PointBatch, mesh: Mesh) -> PointBatch:
    """This rank's contiguous chunk of every window's points (``[B, N, ...]`` -> ``[B, N/points, ...]``);
    ``N`` must divide evenly, as JAX's ``_ds_point_slicer`` asks."""
    n = points.x.shape[1]
    if n % mesh.points:
        raise ValueError(f"{n} points a window do not split into the mesh's {mesh.points} point chunks; "
                         "make the point counts multiples of mesh.points, or use points=1")
    k = n // mesh.points
    lo = mesh.points_index * k
    return PointBatch(*(None if a is None else a[:, lo:lo + k] for a in points))


def local_rows(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's windows of a global batch (``B`` divisible by ``data``): the rows of its data slot."""
    b = batch.field.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} windows does not split over the mesh's {mesh.data} data slots")
    k = b // mesh.data
    lo = mesh.data_index * k

    def rows(a):
        return None if a is None else a[lo:lo + k]

    return Batch(field=rows(batch.field), forecast_h=rows(batch.forecast_h),
                 margin=PointBatch(*map(rows, batch.margin)), inter=PointBatch(*map(rows, batch.inter)))


def shard_batch(batch: Batch, mesh: Mesh, rows: bool = True) -> Batch:
    """This rank's block of a batch: its data slot's windows (``rows=False``: the batch holds them
    already, as a rank's loader delivers them) and its chunk of their points."""
    if rows:
        batch = local_rows(batch, mesh)
    if mesh.points == 1:
        return batch
    return batch._replace(margin=point_chunk(batch.margin, mesh), inter=point_chunk(batch.inter, mesh))
