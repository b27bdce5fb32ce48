"""The training step: encode + decode + data loss + PDE residuals + update.

Counterpart of ``deepphysinet_tpu/train/train_step.py``:

  loss(params) = margin_factor * SmoothL1(decode(margin pts), era5)
               + [with_pde] Sum_eq factor_eq * MSE(residual_eq(inter pts))
               + [with_pde] Sum_eq factor_eq * MSE(residual_eq(margin pts))

with forward-mode space-time derivatives from a decode pair or from autograd's
forward mode (``physics/engine.py``), reverse mode over the whole objective for
the parameter gradient, a global-norm clip at 2.5e7 and the optimizer update.

Differences from the JAX step, which is one jitted program:

* the step runs eagerly, and the windows of a batch are a Python loop where
  JAX uses ``vmap``; every metric is the mean over the windows;
* the model's parameters and the optimizer's state are updated in place;
* ``pde_engine`` is ``'kernel'`` (default: a decode pair with a CUDA kernel on
  both passes on a GPU), ``'jvp'`` (the pair's plain version under autograd)
  or ``'linearize'`` (``torch.func.jvp`` over ``PhysicsNet.decode``).
  ``kernel_version`` 7 picks the v4s pair, 4 the v4t pair (or, with
  ``var_major`` off, the ``[N, 6]`` v4 pair), 6 the v6 pair.  The var-major
  layout serves ``'jvp'`` as it serves ``'kernel'`` (the JAX step runs ``'jvp'``
  in ``[N, 6]`` only), so that the two engines differ in nothing but kernel
  against plain version.  Under 6 there is no var-major form, as in JAX
  (``var_major`` holds for 4 and 7 only): both engines run ``[N, 6]``,
  ``'kernel'`` through ``FusedDecodeJvpV6`` and ``'jvp'`` through the plain
  version with the XLA twin's rounding (``jvp_fields(version=6)``), packed or
  dict assembly by ``packed_assembly`` and the criterion;
* the non-finite guard decides on the host whether to step the optimizer,
  which costs one device-to-host read of the gradient norm per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.device import resolve_device
from deepphysinet_tpu_torch.models.init import init_parameters
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops.coords import CoordSpec, encode_coord
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, NormSpec, norm_specs_from_cfg
from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants
from deepphysinet_tpu_torch.physics.engine import (
    PDE_ENGINES, field_derivatives, forward_tangents, fused_kernel_fields, fused_kernel_fields_t,
    jvp_fields, packed_residual_losses_from_primal_tangents,
    packed_residual_losses_from_primal_tangents_t, pde_residual_losses,
    residual_losses_from_fields)
from deepphysinet_tpu_torch.train.losses import build_loss
from deepphysinet_tpu_torch.train.optim import build_optimizer
from deepphysinet_tpu_torch.train.point_fn import inverse_norm_stack, make_phys_fn


class PointBatch(NamedTuple):
    """Sampled points of a batch of windows (margin = labeled ERA5, inter = collocation)."""

    x: torch.Tensor  # [B, N] physical meters
    y: torch.Tensor  # [B, N]
    t: torch.Tensor  # [B, N] physical seconds
    f: torch.Tensor  # [B, N, 1] Coriolis parameter
    nwp: torch.Tensor  # [B, N, 6] normalized interpolated NWP values (conditioning)
    labels: Optional[torch.Tensor] = None  # [B, N, 6] normalized ERA5 labels (margin only)


class Batch(NamedTuple):
    field: torch.Tensor  # [B, L, enc_in] normalized token matrix
    forecast_h: torch.Tensor  # [B] unnormalized lead hours
    margin: PointBatch
    inter: PointBatch


def batch_to_device(batch: Mapping[str, Any], device=None) -> Batch:
    """A ``Batch`` on ``device`` from nested numpy arrays (``data.window.synthetic_batch``)."""
    device = resolve_device(device)

    def put(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32)).to(device)

    def points(d):
        return PointBatch(**{k: put(d.get(k)) for k in PointBatch._fields})

    return Batch(field=put(batch["field"]), forecast_h=put(batch["forecast_h"]),
                 margin=points(batch["margin"]), inter=points(batch["inter"]))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken (updated in place)."""

    step: int
    model: PhysicsNet
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the step."""

    coord_spec: CoordSpec
    obs_specs: Tuple[NormSpec, ...]  # OBS_NAME_ORDER
    loss_factor: Any  # dict of factors (configs/DeepPhysiNet_NCEP_cfg.py:139-148)
    forecast_time_period: float = 360.0
    # lead-time snapping of the reference's distributed path (forecast_h //
    # window_h * window_h before normalization); 0 = off
    forecast_h_snap: float = 0.0
    prediction_loss: str = "WeightSmoothL1Loss"
    prediction_beta: float = 0.1
    pde_loss: str = "MSELoss"
    grad_clip_norm: float = 2.5e7
    constants: PhysicalConstants = DEFAULT_CONSTANTS
    # 'kernel' = a decode pair with a hand-written kernel on both passes;
    # 'jvp' = the pair's plain version under autograd; 'linearize' = forward
    # mode over the model's plain decode (needed for observation
    # normalizations other than mean_norm)
    pde_engine: str = "kernel"
    # decode-kernel generation of the 'kernel' and 'jvp' engines: 7 = the v4s
    # pair (channel-major trig operand, PE derivative folded into the weights),
    # 4 = the v4 / v4t pair (interleaved PE plus the compact tangent input dpe),
    # 6 = the v6 pair (direction-major trig blocks, [N, 6] outputs only).
    # The same function every way; train_cfg.tpu.kernel_version
    kernel_version: int = 7
    # packed [6, N] residual assembly for the 'kernel' and 'jvp' engines under
    # the MSE criterion; any other criterion and 'linearize' take the dict form
    # of physics/equations.py.  train_cfg.tpu.packed_assembly
    packed_assembly: bool = True
    # var-major [6, N] kernel outputs for the packed path under kernel_version 4
    # and 7; off = the [N, 6] pair
    var_major: bool = True

    def factors(self) -> Dict[str, float]:
        return dict(self.loss_factor)


def step_config_from_cfg(config: Mapping[str, Any], pred_t_span: float = 86400.0,
                         **overrides) -> StepConfig:
    """Hydrate from a reference-schema ``config`` dict, as the JAX interface does
    (interface_physics.py:218-238)."""
    train = config["train_cfg"]
    tpu_cfg = train.get("tpu", {})
    kernel_version = int(tpu_cfg.get("kernel_version", 7))
    _check_kernel_version(kernel_version)
    img = train["img_size"]
    lat_size, lon_size = (int(img), int(img)) if isinstance(img, (int, float)) else map(int, img)
    specs = norm_specs_from_cfg(config["obs_norm_cfg"])
    losses = train["losses"]
    fields = dict(
        coord_spec=CoordSpec(lon_size=lon_size, lat_size=lat_size, dx=float(train.get("dx", 27000)),
                             dy=float(train.get("dy", 27000)), pred_t_span=float(pred_t_span)),
        obs_specs=tuple(specs[k] for k in OBS_NAME_ORDER),
        loss_factor=dict(losses["loss_factor"]),
        forecast_time_period=float(train.get("train_data", {}).get("forecast_time_period", 360)),
        prediction_loss=losses["prediction_loss"]["name"],
        prediction_beta=float(losses["prediction_loss"].get("beta", 0.1)),
        pde_loss=losses["pde_loss"]["name"],
        kernel_version=kernel_version,
        packed_assembly=bool(tpu_cfg.get("packed_assembly", True)),
    )
    fields.update(overrides)
    return StepConfig(**fields)


def _check_kernel_version(kernel_version: int) -> None:
    if kernel_version not in (4, 6, 7):
        raise NotImplementedError(
            f"kernel_version={kernel_version} needs decode kernels that are not ported yet "
            "(ROADMAP B8: v2, v3, v5, v4pe); use 4, 6 or 7")


def _check_supported(cfg: StepConfig) -> None:
    if cfg.pde_engine not in PDE_ENGINES:
        raise ValueError(f"unknown pde_engine {cfg.pde_engine!r}; expected one of {PDE_ENGINES}")
    _check_kernel_version(cfg.kernel_version)


def _snap_forecast_h(forecast_h: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    """Snap lead hours down to the window grid when cfg.forecast_h_snap > 0."""
    if cfg.forecast_h_snap > 0:
        return torch.floor(forecast_h / cfg.forecast_h_snap) * cfg.forecast_h_snap
    return forecast_h


def _window(points: PointBatch, b: int) -> PointBatch:
    return PointBatch(*(None if a is None else a[b] for a in points))


def _window_losses(
    model: PhysicsNet,
    tokens: torch.Tensor,  # [T, D]
    fore_h: torch.Tensor,  # [1]
    margin: PointBatch,  # one window: no leading axis
    inter: PointBatch,
    cfg: StepConfig,
    with_pde: bool,
    pred_loss_fn,
    pde_criterion=None,  # None = MSE, which has the packed assembly
) -> Dict[str, torch.Tensor]:
    """Losses of one window.

    With the PDE terms, the margin points' primal decode is shared between the
    data loss and the margin PDE evaluation: the engine's normalized primal is
    the data-loss prediction, so the 20,480 margin points decode once."""
    factors = cfg.factors()
    out: Dict[str, torch.Tensor] = {}

    linearize = cfg.pde_engine == "linearize"
    packed = cfg.packed_assembly and pde_criterion is None
    # the packed path in [6, N] throughout: kernel outputs, assembly, data loss
    var_major = (cfg.var_major and packed and with_pde and not linearize
                 and cfg.kernel_version in (4, 7))

    def engine_fields(pts: PointBatch):
        """(normalized primal, raw tangents or FieldDerivatives) through cfg.pde_engine."""
        coords = torch.stack([pts.x, pts.y, pts.t], dim=-1)
        if var_major:
            return fused_kernel_fields_t(model, tokens, coords, pts.nwp, fore_h, cfg.coord_spec,
                                         engine=cfg.pde_engine, version=cfg.kernel_version)
        if cfg.pde_engine == "kernel":
            return fused_kernel_fields(model, tokens, coords, pts.nwp, fore_h, cfg.coord_spec,
                                       cfg.obs_specs, with_clip=True, trainable=True,
                                       version=cfg.kernel_version, raw_tangents=packed)
        return jvp_fields(model, tokens, coords, pts.nwp, fore_h, cfg.coord_spec, cfg.obs_specs,
                          with_clip=True, version=cfg.kernel_version, raw_tangents=packed)

    def engine_losses(pred, fd_or_tang, coriolis_f):
        """Residual losses from the second output of ``engine_fields``."""
        if var_major:
            return packed_residual_losses_from_primal_tangents_t(
                pred, fd_or_tang, coriolis_f, cfg.obs_specs, factors, with_clip=True,
                constants=cfg.constants)
        if packed:
            return packed_residual_losses_from_primal_tangents(
                pred, fd_or_tang, coriolis_f, cfg.obs_specs, factors, with_clip=True,
                constants=cfg.constants)
        return residual_losses_from_fields(fd_or_tang, coriolis_f, factors, cfg.constants,
                                           pde_criterion)

    if with_pde and linearize:
        # shared margin evaluation: data loss and PDE terms from one forward-mode
        # evaluation of a combined (normalized, physical) head
        margin_nwp = margin.nwp.detach()

        def combo_fn(coords):
            pe = encode_coord(coords[:, 0], coords[:, 1], coords[:, 2], cfg.coord_spec)
            out_norm = model.decode(tokens, pe, margin_nwp, fore_h)
            phys = inverse_norm_stack(out_norm, cfg.obs_specs, with_clip=True)
            return torch.cat([out_norm, phys], dim=-1)  # [N, 12]

        primal, tangents = forward_tangents(combo_fn, torch.stack([margin.x, margin.y, margin.t], dim=-1))
        pred = primal[:, :6]
        m_losses = residual_losses_from_fields(
            field_derivatives(primal[:, 6:], [t[:, 6:] for t in tangents]), margin.f, factors,
            cfg.constants, pde_criterion)
    elif with_pde:
        # shared margin evaluation through the jvp / kernel engine: the engine's
        # normalized primal is the data-loss prediction
        pred, fd = engine_fields(margin)
        m_losses = engine_losses(pred, fd, margin.f)
    else:
        # data loss only, through the plain per-variable decode
        pe = encode_coord(margin.x, margin.y, margin.t, cfg.coord_spec)
        pred = model.decode(tokens, pe, margin.nwp, fore_h)
    if with_pde:
        for k, v in m_losses.items():
            out[f"margin_{k}"] = v

    # a var-major pred is [6, N]; the loss is elementwise + mean, so the
    # transposed labels (data) keep the whole gradient path in [6, N]
    labels = margin.labels.t() if var_major else margin.labels
    out["margin_loss"] = pred_loss_fn(pred, labels) * factors["margin_factor"]
    out["_pred_norm"] = pred.detach().t() if var_major else pred.detach()

    if with_pde:
        # interior collocation points
        if linearize:
            phys_fn = make_phys_fn(model, tokens, inter.nwp, fore_h, cfg.coord_spec, cfg.obs_specs,
                                   with_clip=True)
            i_losses = pde_residual_losses(
                phys_fn, torch.stack([inter.x, inter.y, inter.t], dim=-1), inter.f, factors,
                cfg.constants, pde_criterion)
        else:
            i_losses = engine_losses(*engine_fields(inter), inter.f)
        for k, v in i_losses.items():
            out[f"inter_{k}"] = v
    return out


def make_loss_fn(model: PhysicsNet, cfg: StepConfig):
    """``loss_fn(batch, with_pde) -> (total, (metrics, pred_norm [B, N, 6]))``.

    The loss of the model's current parameters.  Every metric is the mean over
    the windows of ``batch``."""
    _check_supported(cfg)
    pred_loss_fn = build_loss(cfg.prediction_loss, beta=cfg.prediction_beta)
    pde_criterion = None if cfg.pde_loss == "MSELoss" else build_loss(cfg.pde_loss)

    def loss_fn(batch: Batch, with_pde: bool):
        fh_norm = (_snap_forecast_h(batch.forecast_h, cfg) / cfg.forecast_time_period)[:, None]
        tokens = model.encode(batch.field, fh_norm)  # [B, T, D]
        per_window = [
            _window_losses(model, tokens[b], fh_norm[b], _window(batch.margin, b),
                           _window(batch.inter, b), cfg, with_pde, pred_loss_fn, pde_criterion)
            for b in range(batch.field.shape[0])]
        pred_norm = torch.stack([w.pop("_pred_norm") for w in per_window])
        metrics = {k: torch.stack([w[k] for w in per_window]).mean() for k in per_window[0]}
        total = metrics["margin_loss"]
        if with_pde:
            total = total + metrics["inter_total"] + metrics["margin_total"]
        metrics["total_loss"] = total
        return total, (metrics, pred_norm)

    return loss_fn


def apply_gradient_update(cfg: StepConfig, state: TrainState,
                          metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradient clip + optimizer update + non-finite guard, on ``p.grad``.

    Clip at 2.5e7 (reference interface_physics.py:514) with the scale
    ``min(1, clip / (norm + 1e-6))``.  On a non-finite gradient norm the
    optimizer is not stepped at all, so the parameters AND the optimizer's
    state (Adam's moments and step count) stay as they were: one bad batch
    cannot poison the run (the loss factors span 1e-7..1e14).  ``state.step``
    counts the batch either way."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:  # a parameter off the loss's path still decays
            p.grad = torch.zeros_like(p)
    gnorm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params]))
    finite = bool(torch.isfinite(gnorm))  # the step's one device-to-host read
    metrics["grad_norm"] = gnorm
    metrics["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=gnorm.device)
    if finite:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        torch._foreach_mul_([p.grad for p in params], scale)
        state.optimizer.step()
    state.step += 1
    return metrics


def _variable_metrics(pred_norm: torch.Tensor, labels: torch.Tensor, cfg: StepConfig):
    """Per-variable MSE in physical units (reference interface_physics.py:520-530)."""
    b, n, _ = pred_norm.shape
    pred_phys = inverse_norm_stack(pred_norm.reshape(b * n, 6), cfg.obs_specs, with_clip=True)
    label_phys = inverse_norm_stack(labels.reshape(b * n, 6), cfg.obs_specs, with_clip=True)
    d = (pred_phys - label_phys).float()
    mse = torch.mean(d * d, dim=0)
    return {f"margin_{k}_loss": mse[i] for i, k in enumerate(("u", "v", "p", "T", "q", "rio"))}


def make_train_step(cfg: StepConfig):
    """Returns ``train_step(state, batch, with_pde) -> (state, metrics)``.

    ``state`` is updated in place and returned.  The metrics are 0-d tensors on
    the model's device."""
    _check_supported(cfg)

    def train_step(state: TrainState, batch: Batch, with_pde: bool):
        state.optimizer.zero_grad(set_to_none=True)
        total, (metrics, pred_norm) = make_loss_fn(state.model, cfg)(batch, with_pde)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = apply_gradient_update(cfg, state, metrics)
        with torch.no_grad():
            metrics.update(_variable_metrics(pred_norm, batch.margin.labels, cfg))
        return state, metrics

    return train_step


def make_eval_step(cfg: StepConfig):
    """Validation losses without the update (reference interface_physics.py:639-751):
    ``eval_step(model, batch, with_pde) -> metrics``."""
    _check_supported(cfg)

    @torch.no_grad()
    def eval_step(model: PhysicsNet, batch: Batch, with_pde: bool):
        _, (metrics, pred_norm) = make_loss_fn(model, cfg)(batch, with_pde)
        metrics.update(_variable_metrics(pred_norm, batch.margin.labels, cfg))
        return metrics

    return eval_step


def create_train_state(meta_cfg: Mapping[str, Any], net_cfg: Mapping[str, Any],
                       optimizer_cfg: Mapping[str, Any], generator: torch.Generator,
                       compute_dtype=torch.float32, device=None) -> TrainState:
    """A freshly initialized model (weights drawn from ``generator``) and its optimizer.

    ``optimizer_cfg`` is the configuration's ``train_cfg.optimizer`` dict
    (``name``, ``lr``, ``weight_decay``, ...).  ``device=None`` is the first
    CUDA device, an error without one."""
    model = PhysicsNet(meta_cfg, net_cfg, compute_dtype=compute_dtype, device=device)
    init_parameters(model, generator)
    optimizer = build_optimizer(params=model.parameters(), **dict(optimizer_cfg))
    return TrainState(step=0, model=model, optimizer=optimizer)
