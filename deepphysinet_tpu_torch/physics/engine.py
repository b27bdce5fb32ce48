"""Decode engine: the collapsed decode of inference and the PDE residual engines.

Counterpart of ``deepphysinet_tpu/physics/engine.py``:

* ``FieldDerivatives``, ``linearized_fields`` (:41) and ``pde_residual_losses``
  (:699): the ``'linearize'`` engine, forward-mode derivatives of a point
  function (``train/point_fn.py::make_phys_fn``) through ``torch.func.jvp``;
* ``residual_losses_from_fields`` (:72) and ``fields_from_primal_tangents``
  (:106): the dict form of the residual assembly over
  ``physics/equations.py``, which takes any PDE criterion;
* ``_kernel_inputs`` (:351-364) and ``collapsed_decode_t`` (:578-611), the
  forward-only decode of inference.  The JAX package ships the XLA twin there
  because its Pallas kernel measured slower on the TPU; the port always calls
  ``decode_primal_v4t``, which launches the Hopper kernel whenever the tensors
  are on a GPU;
* ``_kernel_inputs_s`` (:367) and ``fused_kernel_fields_t`` (:307-348): the
  trainable var-major decode, primal plus three space-time tangents, through
  the v4t pair (``version=4``) or the v4s pair (``version=7``), each with a
  hand-written kernel on both passes (engine ``'kernel'``) or as its plain
  version under autograd (engine ``'jvp'``);
* ``fused_kernel_fields`` (:380-487) and ``jvp_fields`` (:490-548): the ``[N, 6]``
  forms, with JAX's routes.  ``fused_kernel_fields``: version 7 means 4; 6 runs the
  v6 pair on the direction-major trig blocks; 4 the v4 pair, or with
  ``in_kernel_pe`` and not ``trainable`` the v4pe kernel on raw coordinates; any
  other version (2, and 3 and 5 as in JAX: ROADMAP C20) the round-1 v2 decode,
  ``FusedDecodeJvpV2`` when ``trainable``.  ``jvp_fields``: 6 the v6 twin, any other
  version the v4 twin;
* ``fused_residual_losses`` (:626-696): the forward-only residual losses of the
  evaluation sweeps.  Versions 4 and 7 run a var-major split path; any other takes
  the in-kernel residual assembly (``ops/residual_kernel.py``: the v6 layer 1 for 6,
  the v4 one otherwise) from ``FUSED_ASSEMBLY_MIN_N`` points on and the split path
  (``fused_kernel_fields``, dict-form assembly) below;
* the packed residual assembly: ``packed_physical_from_primal_tangents`` (:147)
  and its var-major form (:167), ``saturation_specific_humidity_packed``
  (:270), ``residual_losses_packed`` (:211, with ``detach()`` exactly where
  ``stop_gradient`` stands) and ``packed_residual_losses_from_primal_tangents``
  (:277) and its var-major form (:292).

The JAX functions take ``interpret`` (run the Pallas kernels in interpret mode)
and the evaluation sweeps ``use_kernel``; the port carries neither: a wrapper
launches its kernel on a CUDA tensor and runs its plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.decode_kernel import (
    decode_jvp_v4_ref, decode_jvp_v4s_ref, decode_jvp_v6_ref, decode_primal_v4t,
    extract_decode_weights, fuse_decode_weights, fuse_v6_from_v4, fused_decode_jvp,
    fused_decode_jvp_trainable, fused_decode_jvp_v4, fused_decode_jvp_v4_kbwd, fused_decode_jvp_v4pe,
    fused_decode_jvp_v4s, fused_decode_jvp_v4s_kbwd, fused_decode_jvp_v4t, fused_decode_jvp_v4t_kbwd,
    fused_decode_jvp_v6, fused_decode_jvp_v6_kbwd, pe_and_tangents, pe_primal, trig3_inputs,
    trig_cm_inputs)
from deepphysinet_tpu_torch.ops.normalization import inverse_normalize
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe, sinecos_pe_flat
from deepphysinet_tpu_torch.ops.residual_kernel import kernel_residual_losses
from deepphysinet_tpu_torch.physics import equations as eqs
from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants

PDE_ENGINES = ("kernel", "jvp", "linearize")
FIELD_KEYS = ("u", "v", "p", "T", "q", "rio")
_CLIPPED = (False, False, True, True, True, True)  # u, v never clip


@dataclasses.dataclass
class FieldDerivatives:
    """Physical fields and their x / y / t derivatives at the collocation points."""

    fields: Dict[str, torch.Tensor]  # each [N, 1]
    derivs: Dict[str, Dict[str, torch.Tensor]]  # derivs[var][axis] -> [N, 1]


def field_derivatives(primal: torch.Tensor, tangents) -> FieldDerivatives:
    """``FieldDerivatives`` from physical fields [N, 6] and their x, y, t tangents (each [N, 6])."""
    fields = {k: primal[:, i : i + 1] for i, k in enumerate(FIELD_KEYS)}
    derivs = {k: {ax: tangents[j][:, i : i + 1] for j, ax in enumerate(("x", "y", "t"))}
              for i, k in enumerate(FIELD_KEYS)}
    return FieldDerivatives(fields=fields, derivs=derivs)


def forward_tangents(fn: Callable[[torch.Tensor], torch.Tensor], coords: torch.Tensor):
    """``fn(coords)`` and its derivatives along x, y and t: ``(primal, [dx, dy, dt])``.

    Forward mode (``torch.func.jvp``), one pass per direction; the result stays
    differentiable in reverse mode with respect to what ``fn`` closes over.
    JAX's ``linearize`` traces the primal once; here each pass recomputes it."""
    primal, tangents = None, []
    for axis in range(3):
        basis = torch.zeros_like(coords)
        basis[:, axis] = 1.0
        primal, tangent = torch.func.jvp(fn, (coords,), (basis,))
        tangents.append(tangent)
    return primal, tangents


def linearized_fields(phys_fn: Callable[[torch.Tensor], torch.Tensor],
                      coords: torch.Tensor) -> FieldDerivatives:
    """Evaluate ``phys_fn`` and its x / y / t Jacobian columns at ``coords [N, 3]``."""
    return field_derivatives(*forward_tangents(phys_fn, coords))


def _mse(diff: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    d = (diff - const).float()
    return torch.mean(d * d)


def _total(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (losses["montion_u_loss"] + losses["montion_v_loss"] + losses["energy_loss"]
            + losses["continous_loss"] + losses["vapor_loss"] + losses["gas_loss"])


def residual_losses_from_fields(
    fd: FieldDerivatives,
    coriolis_f: torch.Tensor,
    loss_factor: Dict[str, float],
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
    criterion: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """The six equation losses from already-computed fields and derivatives.

    ``criterion(pred, target) -> scalar`` defaults to MSE (the reference
    configuration's pde_loss); any registered loss can be passed."""
    crit = criterion or _mse
    fields, derivs = fd.fields, fd.derivs
    pairs = {
        "montion_u_loss": (eqs.momentum_u_residual(fields, derivs, coriolis_f, constants),
                           "motion_u_factor"),
        "montion_v_loss": (eqs.momentum_v_residual(fields, derivs, coriolis_f, constants),
                           "motion_v_factor"),
        "continous_loss": (eqs.continuity_residual(fields, derivs, constants), "continuous_factor"),
        "energy_loss": (eqs.energy_residual(fields, derivs, constants), "energy_factor"),
        "vapor_loss": (eqs.vapor_residual(fields, derivs, constants), "vapor_factor"),
        "gas_loss": (eqs.gas_residual(fields, constants), "gas_factor"),
    }
    losses = {k: crit(diff, const) * loss_factor[fk] for k, ((diff, const), fk) in pairs.items()}
    losses["total"] = _total(losses)
    return losses


def pde_residual_losses(
    phys_fn: Callable[[torch.Tensor], torch.Tensor],
    coords: torch.Tensor,  # [N, 3] physical (x m, y m, t s)
    coriolis_f: torch.Tensor,  # [N, 1]
    loss_factor: Dict[str, float],
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
    criterion: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """All six equation losses of one collocation batch through the ``'linearize'`` engine.

    Mirrors place_one_batch (reference interface_physics.py:271-320): each
    residual against its balance term under the PDE criterion (MSE by default),
    scaled by its configured factor; their sum under ``"total"``."""
    fd = linearized_fields(phys_fn, coords)
    return residual_losses_from_fields(fd, coriolis_f, loss_factor, constants, criterion)


def _cd_pe(model, coord_data: torch.Tensor) -> torch.Tensor:
    """Compute-dtype PE of the conditioning values [N, 6] -> [N, in_ch]."""
    cd_freqs = make_freq_bands(model.net_cfg["in_channels"] // 2 // 6, max_freq=4.0)
    return sinecos_pe_flat(coord_data, cd_freqs, dtype=model.compute_dtype)


def _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec, tangents: bool = True):
    """Per-window decode weights plus the compute-dtype PE inputs of the points:
    ``(weights, pe, dpe, cd_pe)``; ``dpe`` is ``None`` without ``tangents``."""
    weights = extract_decode_weights(model, tokens, fore_h)
    if tangents:
        pe, dpe = pe_and_tangents(coords, coord_spec, dtype=model.compute_dtype)
    else:
        pe, dpe = pe_primal(coords, coord_spec, dtype=model.compute_dtype), None
    return weights, pe, dpe, _cd_pe(model, coord_data)


def _kernel_inputs_6(model, tokens, coords, coord_data, fore_h, coord_spec):
    """v6 inputs (:430-436): the fused weights, the direction-major trig blocks in the
    compute dtype (every consumer rounds them to it) and the cd PE in float32, as the
    JAX engine hands it on: the kernel wrappers cast it, the plain twin of ``jvp_fields``
    reads it unrounded in its ``wdwo`` sum."""
    weights = extract_decode_weights(model, tokens, fore_h)
    trig = trig3_inputs(coords, coord_spec, dtype=model.compute_dtype)
    cd_freqs = make_freq_bands(model.net_cfg["in_channels"] // 2 // 6, max_freq=4.0)
    cd_pe = sinecos_pe(coord_data, cd_freqs, include_input=False)
    return fuse_v6_from_v4(fuse_decode_weights(weights), coord_spec), trig, cd_pe


def _kernel_inputs_s(model, tokens, coords, coord_data, fore_h, coord_spec):
    """v4s kernel inputs: decode weights, channel-major trig operand and cd PE."""
    weights = extract_decode_weights(model, tokens, fore_h)
    pe_cm = trig_cm_inputs(coords, coord_spec, dtype=model.compute_dtype)
    return weights, pe_cm, _cd_pe(model, coord_data)


@torch.no_grad()
def collapsed_decode_t(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
) -> torch.Tensor:
    """Var-major normalized primal decode [6, N] via the collapsed v4 algebra."""
    weights, pe, _, cd_pe = _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec,
                                           tangents=False)
    fw = fuse_decode_weights(weights)
    ref_t = coord_data.float().t().contiguous()
    return decode_primal_v4t(fw, pe, cd_pe, ref_t, compute_dtype=model.compute_dtype)


def _check_engine(engine: str) -> None:
    if engine not in ("kernel", "jvp"):
        raise ValueError(f"unknown engine {engine!r}; expected 'kernel' or 'jvp'")


def fused_kernel_fields_t(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
    engine: str = "kernel",
    version: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Var-major trainable decode: ``(primal_t [6, N], tang_t [3, 6, N])``.

    Gradients reach the hypernet parameters and the tokens through the
    per-window fusion (``extract_decode_weights`` -> ``fuse_decode_weights``, and
    ``fuse_v6_from_v4`` for version 7).  The points' inputs are data:
    ``coord_data`` is detached, and the PE inputs carry no graph.
    ``version=4`` runs the v4t pair on the interleaved PE and the compact
    tangent input ``dpe``; ``version=7`` the v4s pair on the channel-major trig
    operand.  ``engine='kernel'`` runs the pair's ``torch.autograd.Function`` (a
    kernel on both passes on a GPU); ``engine='jvp'`` its plain version under
    autograd."""
    _check_engine(engine)
    if version not in (4, 7):  # the JAX step takes the var-major path under 4 and 7 only
        raise ValueError(f"fused_kernel_fields_t: decode-kernel version {version} has no var-major "
                         "form; use 4 or 7, or fused_kernel_fields")
    coord_data = coord_data.detach()
    ref_t = coord_data.float().t().contiguous()
    cdt = model.compute_dtype
    if version == 7:
        weights, pe_cm, cd_pe = _kernel_inputs_s(model, tokens, coords.detach(), coord_data, fore_h,
                                                 coord_spec)
        fw6 = fuse_v6_from_v4(fuse_decode_weights(weights), coord_spec)
        if engine == "kernel":
            return fused_decode_jvp_v4s_kbwd(fw6, pe_cm, cd_pe, ref_t, cdt)
        return decode_jvp_v4s_ref(fw6, pe_cm, cd_pe, ref_t, cdt)
    weights, pe, dpe, cd_pe = _kernel_inputs(model, tokens, coords.detach(), coord_data, fore_h,
                                             coord_spec)
    fw = fuse_decode_weights(weights)
    if engine == "kernel":
        return fused_decode_jvp_v4t_kbwd(fw, pe, dpe, cd_pe, ref_t, cdt)
    return decode_jvp_v4_ref(fw, pe, dpe, cd_pe, ref_t, cdt, t_layout=True)


def fields_from_primal_tangents(
    primal: torch.Tensor,  # [N, 6] normalized decode outputs
    tang: torch.Tensor,  # [3, N, 6] d(normalized)/d(physical x, y, t)
    obs_specs,
    with_clip: bool,
) -> FieldDerivatives:
    """Inverse-normalization chain rule and clip masking -> physical fields and derivatives.

    For mean_norm, d(phys)/dx = std * d(norm)/dx; where the clip is active the
    derivative is zero (``torch.clip`` semantics, matching the linearize path)."""
    fields, derivs = {}, {}
    for i, key in enumerate(FIELD_KEYS):
        spec = obs_specs[i]
        if spec.use_norm and spec.norm_type.lower() != "mean_norm":
            raise NotImplementedError(
                "the fused decode's chain rule supports mean_norm only; use the "
                f"linearize engine for {spec.name} ({spec.norm_type})")
        p_norm = primal[:, i : i + 1]
        clip = with_clip and _CLIPPED[i] and spec.bound is not None
        scale = float(np.float32(spec.norm_factor[1])) if spec.use_norm else 1.0
        if clip:
            lo, hi = spec.bound
            unclipped = inverse_normalize(p_norm, spec, with_clip=False)
            scale = scale * ((unclipped > lo) & (unclipped < hi)).float()
        fields[key] = inverse_normalize(p_norm, spec, with_clip=clip)
        derivs[key] = {ax: tang[j, :, i : i + 1] * scale for j, ax in enumerate(("x", "y", "t"))}
    return FieldDerivatives(fields=fields, derivs=derivs)


def fused_kernel_fields(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
    obs_specs,
    with_clip: bool = True,
    trainable: bool = False,
    version: int = 4,
    in_kernel_pe: bool = False,
    raw_tangents: bool = False,
):
    """``(primal_norm [N, 6], FieldDerivatives)`` via a decode kernel.

    With ``raw_tangents`` the normalized ``tang [3, N, 6]`` is returned instead
    of the assembled ``FieldDerivatives`` (for the packed assembly).  The
    normalized primal comes back beside the fields so that the training step
    can use it as the data-loss prediction.  ``trainable`` goes through the
    version's ``torch.autograd.Function``, so the result can sit inside a
    differentiated loss; otherwise the forward kernel alone runs and the result
    carries no graph on a GPU.  The routes are JAX's (:418-484):

    * ``version=7`` means the v4 algebra here, as in ``jvp_fields``: v4s is a
      var-major variant (``fused_kernel_fields_t``);
    * ``version=6``: the v6 pair (``FusedDecodeJvpV6`` when ``trainable``), the PE
      derivative folded into the per-window weights;
    * ``version=4``: the v4 pair (``FusedDecodeJvpV4``, a kernel on both passes),
      or with ``in_kernel_pe`` and not ``trainable`` the v4pe kernel, which
      computes the PE from raw coordinates;
    * any other version: the uncollapsed v2 decode, ``FusedDecodeJvpV2`` (the v2
      forward kernel, the plain version's gradient) when ``trainable``.  JAX runs
      versions 3 and 5 here too, not through their own kernels (ROADMAP C20)."""
    if version == 7:
        version = 4
    coord_data = coord_data.detach()
    ref = coord_data.float().contiguous()
    cdt = model.compute_dtype
    if version == 6:
        fw6, trig, cd_pe = _kernel_inputs_6(model, tokens, coords.detach(), coord_data, fore_h, coord_spec)
        decode = fused_decode_jvp_v6_kbwd if trainable else fused_decode_jvp_v6
        primal, tang = decode(fw6, trig, cd_pe, ref, cdt)
    elif version == 4 and in_kernel_pe and not trainable:
        fw = fuse_decode_weights(extract_decode_weights(model, tokens, fore_h))
        primal, tang = fused_decode_jvp_v4pe(fw, coords.detach(), ref, coord_spec, cdt)
    else:
        weights, pe, dpe, cd_pe = _kernel_inputs(model, tokens, coords.detach(), coord_data, fore_h,
                                                 coord_spec)
        if version == 4:
            decode = fused_decode_jvp_v4_kbwd if trainable else fused_decode_jvp_v4
            primal, tang = decode(fuse_decode_weights(weights), pe, dpe, cd_pe, ref, cdt)
        else:
            decode = fused_decode_jvp_trainable if trainable else fused_decode_jvp
            primal, tang = decode(weights, pe, dpe, cd_pe, ref, cdt)
    if raw_tangents:
        return primal, tang
    return primal, fields_from_primal_tangents(primal, tang, obs_specs, with_clip)


def jvp_fields(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
    obs_specs,
    with_clip: bool = True,
    version: int = 4,
    raw_tangents: bool = False,
):
    """Analytic-tangent fields through the collapsed v4 algebra in plain PyTorch.

    ``(primal_norm [N, 6], FieldDerivatives)``, fully differentiable by
    autograd.  Mirrors the JAX ``jvp_fields`` over its XLA twin
    ``decode_jvp_xla_v4``, which keeps the masked tangents float32 for the
    ``w2wo`` sum (``round_tangents=False``).  ``version=6`` is the trig-input
    formulation over ``decode_jvp_xla_v6``, which besides reads the cd PE in
    float32 in its ``wdwo`` sum.  Every other version is treated as 4, as in JAX
    (:521-548): 7 is a kernel layout choice with no meaning here, and the
    uncollapsed v2 decode is the same function."""
    coord_data = coord_data.detach()
    if version == 6:
        fw6, trig, cd_pe = _kernel_inputs_6(model, tokens, coords.detach(), coord_data, fore_h, coord_spec)
        primal, tang = decode_jvp_v6_ref(fw6, trig, cd_pe, coord_data.float(), model.compute_dtype,
                                         round_tangents=False)
    else:
        weights, pe, dpe, cd_pe = _kernel_inputs(model, tokens, coords.detach(), coord_data, fore_h,
                                                 coord_spec)
        primal, tang = decode_jvp_v4_ref(fuse_decode_weights(weights), pe, dpe, cd_pe,
                                         coord_data.float(), model.compute_dtype, round_tangents=False)
    if raw_tangents:
        return primal, tang
    return primal, fields_from_primal_tangents(primal, tang, obs_specs, with_clip)


# The JAX package's crossover for every version whose split path is point-major
# ([N, 6] outputs): from this many points on, its in-kernel residual assembly
# overtook the split path on the TPU.  The port keeps the value; what the H100 says
# about it is in PERF.md.  Versions 4 and 7 have var-major split paths and never
# dispatch to the in-kernel assembly: the v4 residual kernel is reached only by a
# direct call of ``kernel_residual_losses(version=4)``.
FUSED_ASSEMBLY_MIN_N = 49152


@torch.no_grad()
def fused_residual_losses(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coriolis_f: torch.Tensor,  # [N, 1]
    coord_spec,
    obs_specs,
    loss_factor: Dict[str, float],
    with_clip: bool = True,
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
    version: int = 4,
) -> Dict[str, torch.Tensor]:
    """Forward-only residual losses (MSE criterion): the evaluation sweeps' path.

    JAX's routes (:665-696): ``version=4``: the var-major v4t forward kernel, then
    the packed ``[6, N]`` assembly; ``version=7``: the same with the v4s forward
    kernel; any other version: the in-kernel residual assembly
    (``kernel_residual_losses``, one launch; the v6 layer 1 for 6, the v4 one
    otherwise) from ``FUSED_ASSEMBLY_MIN_N`` points on, and below it the split path
    of ``fused_kernel_fields`` (the v6 forward kernel for 6, the v2 one for 2) and
    the dict-form assembly.  Not differentiable; training goes through
    ``fused_kernel_fields_t`` or ``fused_kernel_fields``."""
    if version not in (4, 7):
        if coords.shape[0] >= FUSED_ASSEMBLY_MIN_N:
            return kernel_residual_losses(
                model, tokens, coords, coord_data, fore_h, coriolis_f, coord_spec, obs_specs,
                loss_factor, with_clip=with_clip, constants=constants, version=version)
        _, fd = fused_kernel_fields(model, tokens, coords, coord_data, fore_h, coord_spec, obs_specs,
                                    with_clip=with_clip, version=version)
        return residual_losses_from_fields(fd, coriolis_f, loss_factor, constants)
    ref_t = coord_data.float().t().contiguous()
    if version == 7:
        weights, pe_cm, cd_pe = _kernel_inputs_s(model, tokens, coords, coord_data, fore_h, coord_spec)
        fw6 = fuse_v6_from_v4(fuse_decode_weights(weights), coord_spec)
        primal_t, tang_t = fused_decode_jvp_v4s(fw6, pe_cm, cd_pe, ref_t, model.compute_dtype)
    else:
        weights, pe, dpe, cd_pe = _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec)
        primal_t, tang_t = fused_decode_jvp_v4t(fuse_decode_weights(weights), pe, dpe, cd_pe, ref_t,
                                                model.compute_dtype)
    return packed_residual_losses_from_primal_tangents_t(
        primal_t, tang_t, coriolis_f, obs_specs, loss_factor, with_clip=with_clip,
        constants=constants)


def packed_physical_from_primal_tangents(
    primal: torch.Tensor,  # [N, 6] normalized decode outputs
    tang: torch.Tensor,  # [3, N, 6] normalized tangents
    obs_specs,
    with_clip: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``packed_physical_from_primal_tangents_t`` on the ``[N, 6]`` layout: the
    vectorized form of ``fields_from_primal_tangents``, var-major out."""
    return packed_physical_from_primal_tangents_t(primal.t(), tang.transpose(1, 2), obs_specs,
                                                  with_clip)


def packed_physical_from_primal_tangents_t(
    primal_t: torch.Tensor,  # [6, N] var-major normalized decode outputs
    tang_t: torch.Tensor,  # [3, 6, N] var-major normalized tangents
    obs_specs,
    with_clip: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(P [6, N] physical fields, D [3, 6, N] physical derivatives)``.

    The mean_norm inverse with ``torch.clip`` semantics: where the clip is
    active, the field sits on the bound and its derivative is zero."""
    mean = np.zeros(6, np.float32)
    std = np.ones(6, np.float32)
    lo = np.full(6, -np.inf, np.float32)
    hi = np.full(6, np.inf, np.float32)
    clip_col = np.zeros(6, bool)
    for i, spec in enumerate(obs_specs):
        if spec.use_norm:
            if spec.norm_type.lower() != "mean_norm":
                raise NotImplementedError(
                    "packed assembly supports mean_norm only; "
                    f"got {spec.name} ({spec.norm_type})")
            mean[i] = np.float32(spec.norm_factor[0])
            std[i] = np.float32(spec.norm_factor[1])
        if with_clip and _CLIPPED[i] and spec.bound is not None:
            lo[i], hi[i] = spec.bound
            clip_col[i] = True

    def col(a):
        return torch.as_tensor(a, device=primal_t.device)[:, None]

    unclipped = primal_t * col(std) + col(mean)
    fields = torch.clamp(unclipped, min=col(lo), max=col(hi))
    in_bounds = ((unclipped > col(lo)) & (unclipped < col(hi))).float()
    scale = torch.where(col(clip_col), col(std) * in_bounds, col(std))  # [6, N]
    return fields, tang_t * scale[None]


def saturation_specific_humidity_packed(p: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Tetens formula on row vectors."""
    t = T - 273.15
    e_s = 6.112 * torch.exp(17.67 * t / (t + 243.5)) * 100.0
    return 0.622 * e_s / (p - 0.378 * e_s)


def residual_losses_packed(
    fields: torch.Tensor,  # [6, N] physical (u, v, p, T, q, rho)
    derivs: torch.Tensor,  # [3, 6, N] physical d/dx, d/dy, d/dt
    coriolis_f: torch.Tensor,  # [N, 1] or [N]
    loss_factor: Dict[str, float],
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
) -> Dict[str, torch.Tensor]:
    """The six primitive-equation losses (MSE criterion) on the packed layout.

    All six equations share the advective operator D(.)/Dt, computed once on
    the full [6, N] block.  ``q_s``, ``delta`` and ``f_fac`` of the vapor
    equation are detached, as the reference's stop-gradients are."""
    c = constants
    u, v, p, T, q, rho = (fields[i] for i in range(6))
    f = coriolis_f[:, 0] if coriolis_f.ndim == 2 else coriolis_f
    adv = derivs[2] + u[None, :] * derivs[0] + v[None, :] * derivs[1]  # [6, N]

    r_u = adv[0] + derivs[0, 2] / rho - f * v
    r_v = adv[1] + derivs[1, 2] / rho + f * u
    r_c = adv[5] + rho * (derivs[0, 0] + derivs[1, 1])
    r_e = c.c_p * adv[3] - adv[2] / (rho + c.eps_rho) + c.latent_heat * adv[4]

    dp, dq = adv[2], adv[4]
    q_s = saturation_specific_humidity_packed(p, T).detach()
    q_s = torch.clamp(q_s, min=1e-6)
    delta = torch.where((dp < 0) & (q >= q_s), torch.ones_like(dp), torch.zeros_like(dp)).detach()
    r_moist = (1.0 + 0.608 * q) * c.r_d
    f_fac = (c.latent_heat * r_moist - c.c_p * c.r_v * T) / (
        c.c_p * c.r_v + T * T + c.latent_heat**2 * q_s)
    f_fac = (f_fac * q_s * T).detach()
    r_q = -dp * delta * f_fac / (p + c.eps_rho) + dq

    r_g = p - rho * (1.0 + 0.608 * q) * c.r_d * T

    def mse(r):
        r32 = r.float()
        return torch.mean(r32 * r32)

    losses = {
        "montion_u_loss": mse(r_u) * loss_factor["motion_u_factor"],
        "montion_v_loss": mse(r_v) * loss_factor["motion_v_factor"],
        "continous_loss": mse(r_c) * loss_factor["continuous_factor"],
        "energy_loss": mse(r_e) * loss_factor["energy_factor"],
        "vapor_loss": mse(r_q) * loss_factor["vapor_factor"],
        "gas_loss": mse(r_g) * loss_factor["gas_factor"],
    }
    losses["total"] = _total(losses)
    return losses


def packed_residual_losses_from_primal_tangents(
    primal: torch.Tensor,  # [N, 6]
    tang: torch.Tensor,  # [3, N, 6]
    coriolis_f: torch.Tensor,
    obs_specs,
    loss_factor: Dict[str, float],
    with_clip: bool = True,
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
) -> Dict[str, torch.Tensor]:
    """Packed assembly from the ``[N, 6]`` layout: the v4 pair's outputs -> per-equation losses."""
    fields, derivs = packed_physical_from_primal_tangents(primal, tang, obs_specs, with_clip)
    return residual_losses_packed(fields, derivs, coriolis_f, loss_factor, constants)


def packed_residual_losses_from_primal_tangents_t(
    primal_t: torch.Tensor,  # [6, N] var-major
    tang_t: torch.Tensor,  # [3, 6, N] var-major
    coriolis_f: torch.Tensor,
    obs_specs,
    loss_factor: Dict[str, float],
    with_clip: bool = True,
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
) -> Dict[str, torch.Tensor]:
    """Var-major assembly: the v4t or v4s pair's outputs -> per-equation losses."""
    fields, derivs = packed_physical_from_primal_tangents_t(primal_t, tang_t, obs_specs, with_clip)
    return residual_losses_packed(fields, derivs, coriolis_f, loss_factor, constants)
