"""The data-parallel steps: each rank's step on its block, gradients and metrics averaged over all.

Counterpart of ``deepphysinet_tpu/parallel/sharding.py``.  JAX runs the single-chip step's body under
``shard_map`` on each device's block of the batch (windows over ``data``, each window's points over
``points``) and ``pmean``s gradients and metric scalars over the whole mesh before the clip and the
optimizer.  The port runs ``train/train_step.py``'s loss on the rank's block, then

* one ``all_reduce`` of one flat float32 buffer holding every parameter's gradient, divided by the
  world (``mean_over_ranks_``), and another of the step's metric scalars;
* ``apply_gradient_update`` (clip at 2.5e7, the non-finite guard, the optimizer) on the averaged
  gradients, which every rank holds alike, so every rank's parameters stay the same.

No ``DistributedDataParallel``: the step calls ``PhysicsNet.encode`` and the decode pairs, not
``forward``, so DDP's reducer would never be prepared; the hypernet reads 256 of its tokens and the
key-projection biases take exactly zero gradients (Q1, C4), which DDP's unused-parameter search
would have to be told about.  One explicit reduction a step is what JAX's ``pmean`` is.

Every metric is a plain mean over a rank's windows and points, and every rank holds as many, so the
mean of the ranks' means is the global mean (up to the order of float sums).

Device sampling: every rank draws the GLOBAL ``[B_global, ...]`` draws of a step from the same seeded
generator and keeps its data slot's rows, so a window's points are those that one process would
draw for it (JAX's "window -> key assignment matches the single-controller run"); with ``points`` > 1
each rank then takes its chunk of them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from deepphysinet_tpu_torch.parallel import multihost
from deepphysinet_tpu_torch.parallel.mesh import Mesh, shard_batch
from deepphysinet_tpu_torch.train import device_sampling as ds
from deepphysinet_tpu_torch.train.train_step import (
    Batch, StepConfig, TrainState, _check_supported, _variable_metrics, apply_gradient_update, make_loss_fn)


def mean_over_ranks_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` in place over every rank: one ``all_reduce`` of one flat float32 buffer (in a
    group of one rank too, an identity through the group's backend; without a group, nothing)."""
    if not (dist.is_available() and dist.is_initialized()) or not tensors:
        return
    world = dist.get_world_size()
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over every rank (one all-reduce)."""
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float() for k in keys])
    mean_over_ranks_([vec])
    return dict(zip(keys, vec.unbind()))


def _reduced_update(cfg: StepConfig, state: TrainState, metrics, pred_norm, labels):
    """The averaged gradients through the clip and the optimizer; the averaged metrics."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:  # off the loss's path: zero, as the single-process step takes it
            p.grad = torch.zeros_like(p)
    mean_over_ranks_([p.grad for p in params])
    with torch.no_grad():
        var_m = _variable_metrics(pred_norm, labels, cfg)
    metrics = mean_metrics({**{k: v.detach() for k, v in metrics.items()}, **var_m})
    var_m = {k: metrics.pop(k) for k in var_m}
    metrics = apply_gradient_update(cfg, state, metrics)
    metrics.update(var_m)
    return state, metrics


def make_sharded_train_step(cfg: StepConfig, mesh: Mesh):
    """``step(state, local, with_pde) -> (state, metrics)``: ``local`` is this rank's block
    (``mesh.shard_batch``); the state is updated in place, alike on every rank."""
    _check_supported(cfg)

    def step(state: TrainState, local: Batch, with_pde: bool):
        state.optimizer.zero_grad(set_to_none=True)
        total, (metrics, pred_norm) = make_loss_fn(state.model, cfg)(local, with_pde)
        total.backward()
        return _reduced_update(cfg, state, metrics, pred_norm, local.margin.labels)

    return step


def make_sharded_eval_step(cfg: StepConfig, mesh: Mesh):
    """``eval_step(model, local, with_pde) -> metrics`` averaged over the ranks; a collective, so every
    rank calls it at the same step."""
    _check_supported(cfg)

    @torch.no_grad()
    def eval_step(model, local: Batch, with_pde: bool):
        _, (metrics, pred_norm) = make_loss_fn(model, cfg)(local, with_pde)
        metrics.update(_variable_metrics(pred_norm, local.margin.labels, cfg))
        return mean_metrics(metrics)

    return eval_step


def _ds_point_slicer(mesh: Mesh, scfg: ds.SamplerConfig) -> None:
    """Checks that the sampled point sets split into the mesh's equal point chunks (JAX's
    ``_ds_point_slicer``: sizes that do not divide raise)."""
    for label, n in (("n_margin", scfg.n_margin), ("n_inter", scfg.n_inter)):
        if n % mesh.points:
            raise ValueError(f"SamplerConfig.{label}={n} not divisible by the mesh points axis ({mesh.points}); "
                             "pad the sample sizes or use points=1")


def local_draws(draws: ds.Draws, mesh: Mesh, b_local: int) -> ds.Draws:
    """This rank's rows of a step's global draws ``[b_local * data, ...]``."""
    if draws.mx.shape[0] != b_local * mesh.data:
        raise ValueError(f"draws for {draws.mx.shape[0]} windows, the mesh holds {b_local} x {mesh.data}")
    lo = mesh.data_index * b_local
    return ds.Draws(*(a[lo:lo + b_local] for a in draws))


def _local_batch(cube: ds.CubeBatch, draws: ds.Draws, mesh: Mesh, scfg, coord_spec, device) -> Batch:
    batch = ds.sample_batch(cube, local_draws(draws, mesh, cube.field.shape[0]), scfg, coord_spec, device)
    return shard_batch(batch, mesh, rows=False)


def make_sharded_device_sampling_step(cfg: StepConfig, mesh: Mesh, scfg: ds.SamplerConfig):
    """``step(state, cube, draws, with_pde) -> (state, metrics)``: ``cube`` holds this rank's data
    slot's windows, ``draws`` the step's global draws (``draw_points`` for ``b_local * data``
    windows, the same on every rank); the lead time unsnapped, as JAX's device-sampled loss."""
    _ds_point_slicer(mesh, scfg)
    train_step = make_sharded_train_step(ds._unsnapped(cfg), mesh)

    def step(state: TrainState, cube: ds.CubeBatch, draws: ds.Draws, with_pde: bool):
        device = ds._device_of(state.model)
        return train_step(state, _local_batch(cube, draws, mesh, scfg, cfg.coord_spec, device), with_pde)

    return step


def make_sharded_device_sampling_eval_step(cfg: StepConfig, mesh: Mesh, scfg: ds.SamplerConfig):
    """``eval_step(model, cube, draws, with_pde) -> metrics``: the validation counterpart, a collective."""
    _ds_point_slicer(mesh, scfg)
    eval_step = make_sharded_eval_step(ds._unsnapped(cfg), mesh)

    def step(model, cube: ds.CubeBatch, draws: ds.Draws, with_pde: bool):
        return eval_step(model, _local_batch(cube, draws, mesh, scfg, cfg.coord_spec, ds._device_of(model)), with_pde)

    return step
