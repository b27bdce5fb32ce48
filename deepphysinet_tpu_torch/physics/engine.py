"""Decode engine: the collapsed decode of inference and the PDE residual engine of training.

Counterpart of these parts of ``deepphysinet_tpu/physics/engine.py``:

* ``_kernel_inputs`` (:351-364, without the tangent input ``dpe``) and
  ``collapsed_decode_t`` (:578-611), the forward-only decode of inference.  The
  JAX package ships the XLA twin there because its Pallas kernel measured
  slower on the TPU; the port always calls ``decode_primal_v4t``, which
  launches the Hopper kernel whenever the tensors are on a GPU;
* ``_kernel_inputs_s`` (:367) and ``fused_kernel_fields_t`` for ``version=7``
  (:307-342): the trainable var-major decode, primal plus three space-time
  tangents, through the v4s kernel pair (engine ``'kernel'``) or through its
  plain version under autograd (engine ``'jvp'``);
* the packed ``[6, N]`` residual assembly:
  ``packed_physical_from_primal_tangents_t`` (:167),
  ``saturation_specific_humidity_packed`` (:270), ``residual_losses_packed``
  (:211, with ``detach()`` exactly where ``stop_gradient`` stands) and
  ``packed_residual_losses_from_primal_tangents_t`` (:292).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.decode_kernel import (
    decode_jvp_v4s_ref, decode_primal_v4t, extract_decode_weights, fuse_decode_weights,
    fuse_v6_from_v4, fused_decode_jvp_v4s_kbwd, pe_primal, trig_cm_inputs)
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe_flat
from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants

PDE_ENGINES = ("kernel", "jvp")


def _cd_pe(model, coord_data: torch.Tensor) -> torch.Tensor:
    """Compute-dtype PE of the conditioning values [N, 6] -> [N, in_ch]."""
    cd_freqs = make_freq_bands(model.net_cfg["in_channels"] // 2 // 6, max_freq=4.0)
    return sinecos_pe_flat(coord_data, cd_freqs, dtype=model.compute_dtype)


def _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec):
    """Per-window decode weights plus the compute-dtype PE inputs of the points."""
    weights = extract_decode_weights(model, tokens, fore_h)
    pe = pe_primal(coords, coord_spec, dtype=model.compute_dtype)
    return weights, pe, _cd_pe(model, coord_data)


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
    weights, pe, cd_pe = _kernel_inputs(model, tokens, coords, coord_data, fore_h, coord_spec)
    fw = fuse_decode_weights(weights)
    ref_t = coord_data.float().t().contiguous()
    return decode_primal_v4t(fw, pe, cd_pe, ref_t, compute_dtype=model.compute_dtype)


def fused_kernel_fields_t(
    model,
    tokens: torch.Tensor,  # [T, D]
    coords: torch.Tensor,  # [N, 3] physical
    coord_data: torch.Tensor,  # [N, 6] normalized conditioning values
    fore_h: torch.Tensor,  # [1]
    coord_spec,
    engine: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Var-major trainable decode: ``(primal_t [6, N], tang_t [3, 6, N])``.

    Gradients reach the hypernet parameters and the tokens through the
    per-window fusion (``extract_decode_weights`` -> ``fuse_decode_weights`` ->
    ``fuse_v6_from_v4``).  The points' inputs are data: ``coord_data`` is
    detached, and ``pe_cm`` / ``cd_pe`` carry no graph.  ``engine='kernel'``
    runs ``FusedDecodeJvpV4s`` (a kernel on both passes on a GPU);
    ``engine='jvp'`` runs its plain version ``decode_jvp_v4s_ref`` under
    autograd."""
    if engine not in PDE_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {PDE_ENGINES}")
    coord_data = coord_data.detach()
    weights, pe_cm, cd_pe = _kernel_inputs_s(model, tokens, coords.detach(), coord_data, fore_h,
                                             coord_spec)
    ref_t = coord_data.float().t().contiguous()
    fw6 = fuse_v6_from_v4(fuse_decode_weights(weights), coord_spec)
    if engine == "kernel":
        return fused_decode_jvp_v4s_kbwd(fw6, pe_cm, cd_pe, ref_t, model.compute_dtype)
    return decode_jvp_v4s_ref(fw6, pe_cm, cd_pe, ref_t, model.compute_dtype)


_CLIPPED = (False, False, True, True, True, True)  # u, v never clip


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
    losses["total"] = (
        losses["montion_u_loss"] + losses["montion_v_loss"] + losses["energy_loss"]
        + losses["continous_loss"] + losses["vapor_loss"] + losses["gas_loss"]
    )
    return losses


def packed_residual_losses_from_primal_tangents_t(
    primal_t: torch.Tensor,  # [6, N] var-major
    tang_t: torch.Tensor,  # [3, 6, N] var-major
    coriolis_f: torch.Tensor,
    obs_specs,
    loss_factor: Dict[str, float],
    with_clip: bool = True,
    constants: PhysicalConstants = DEFAULT_CONSTANTS,
) -> Dict[str, torch.Tensor]:
    """Var-major assembly: the v4s pair's outputs -> per-equation losses."""
    fields, derivs = packed_physical_from_primal_tangents_t(primal_t, tang_t, obs_specs, with_clip)
    return residual_losses_packed(fields, derivs, coriolis_f, loss_factor, constants)
