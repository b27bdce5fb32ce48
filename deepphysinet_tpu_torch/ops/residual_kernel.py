"""Collapsed decode with the PDE residual assembly inside the kernel.

Counterpart of ``deepphysinet_tpu/ops/residual_kernel.py``: the forward-only
residual evaluation (MSE criterion, ``mean_norm`` specs) as ONE launch that
decodes the points for all six variables, applies the inverse normalization and
its clip masks, evaluates the six primitive-equation residuals and adds up their
squares; six sums come out.  In bfloat16 the decode is the tensor-core forward
body, one variable a block, whose outputs meet in a scratch array the wrapper
allocates (``scratch_bytes``); in float32 a block decodes its points for all six
variables and keeps them in shared memory.  Either way the split path's
separate assembly in PyTorch (``physics/engine.py::fused_residual_losses``
below its crossover) and its launches are saved.

* ``fused_residual_sums_v4`` (:262-336) over the v4 decode's layer 1 and
  ``fused_residual_sums_v6`` (:192-259) over the v6 decode's: both the CUDA
  kernel ``csrc/residual_sums.cu`` on GPU tensors, whose device-code equations
  are ``csrc/residual_equations.cuh``, and on CPU tensors their plain versions
  ``residual_sums_v4_ref`` / ``residual_sums_v6_ref`` (the plain decode with the
  kernels' rounding, then the assembly of :78-124 through
  ``physics/equations.py``);
* ``kernel_residual_losses`` (:339-397): the seven losses of
  ``engine.residual_losses_from_fields`` from one window's model state.

The JAX functions take ``interpret`` and ``block_n``; the port carries neither:
a wrapper launches its kernel on a CUDA tensor and runs its plain version on a
CPU tensor, and the kernel picks its own block size.  The kernel adds the
blocks' partial sums itself, in a fixed order, so two runs agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from deepphysinet_tpu_torch.ops.decode_kernel import (
    _MAX_SHARED_BYTES, FusedDecodeWeights, FusedDecodeWeightsV6, _FWD_WEIGHTS, _launch,
    decode_jvp_v4_ref, decode_jvp_v6_ref, extract_decode_weights, fuse_decode_weights,
    fuse_v6_from_v4, pe_and_tangents, trig3_inputs)
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.physics import equations as eqs
from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants

SOURCE = "residual_sums.cu"
FIELD_KEYS = ("u", "v", "p", "T", "q", "rio")
# clip applies to p, T, q, rho only -- u, v are never clipped
_CLIPPED = (False, False, True, True, True, True)
EQUATIONS = ("momentum_u", "momentum_v", "continuity", "energy", "vapor", "gas")


class _ResidualParams(ctypes.Structure):
    """``dpn::ResidualParams`` of ``csrc/residual_equations.cuh``."""

    _fields_ = [("std", ctypes.c_float * 6), ("mean", ctypes.c_float * 6),
                ("lo", ctypes.c_float * 6), ("hi", ctypes.c_float * 6), ("clip", ctypes.c_int * 6),
                ("c_p", ctypes.c_float), ("r_d", ctypes.c_float), ("latent_heat", ctypes.c_float),
                ("eps_rho", ctypes.c_float), ("cp_rv", ctypes.c_float),
                ("latent_heat_sq", ctypes.c_float)]


def _norm_constants(obs_specs, with_clip: bool):
    """Per variable: std, mean, and the clip bounds or ``None`` (:208-217)."""
    if len(obs_specs) != len(FIELD_KEYS):
        raise ValueError(f"the residual assembly needs the six variables {FIELD_KEYS}; "
                         f"got {len(obs_specs)} specs")
    for spec in obs_specs:
        if spec.use_norm and spec.norm_type.lower() != "mean_norm":
            raise NotImplementedError(
                f"residual kernel supports mean_norm only, got {spec.norm_type} for {spec.name}")
    stds = tuple(float(s.norm_factor[1]) if s.use_norm else 1.0 for s in obs_specs)
    means = tuple(float(s.norm_factor[0]) if s.use_norm else 0.0 for s in obs_specs)
    bounds = tuple(
        (float(s.bound[0]), float(s.bound[1]))
        if with_clip and _CLIPPED[i] and s.bound is not None else None
        for i, s in enumerate(obs_specs))
    return stds, means, bounds


def residual_point_terms(primal: torch.Tensor, tang: torch.Tensor, coriolis_f: torch.Tensor,
                         obs_specs, with_clip: bool = True,
                         constants: PhysicalConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Squared residuals [6, N] of the six equations from the normalized decode
    outputs ``primal`` [N, 6] and ``tang`` [3, N, 6], in float32 (in float64 for
    float64 outputs, which ``chip_smoke.py`` differentiates).

    The assembly of the TPU kernels (:78-124): ``phys = o * std + mean``, the
    clip mask from the UNCLIPPED value with strict bounds, u and v never
    clipped, then the pairs of ``physics/equations.py``."""
    dt = torch.float64 if primal.dtype == torch.float64 else torch.float32
    stds, means, bounds = _norm_constants(obs_specs, with_clip)
    fields, derivs = {}, {}
    for v, key in enumerate(FIELD_KEYS):
        phys = primal[:, v].to(dt) * stds[v] + means[v]
        scale = stds[v]
        if bounds[v] is not None:
            lo, hi = bounds[v]
            scale = stds[v] * ((phys > lo) & (phys < hi)).to(dt)
            phys = torch.clamp(phys, lo, hi)
        fields[key] = phys
        derivs[key] = {ax: tang[k, :, v].to(dt) * scale for k, ax in enumerate(("x", "y", "t"))}
    f = coriolis_f.reshape(-1).to(dt)
    pairs = (eqs.momentum_u_residual(fields, derivs, f, constants),
             eqs.momentum_v_residual(fields, derivs, f, constants),
             eqs.continuity_residual(fields, derivs, constants),
             eqs.energy_residual(fields, derivs, constants),
             eqs.vapor_residual(fields, derivs, constants),
             eqs.gas_residual(fields, constants))
    diffs = [diff.to(dt) - const.to(dt) for diff, const in pairs]
    return torch.stack([d * d for d in diffs])


@torch.no_grad()
def residual_sums_v4_ref(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                         cd_pe: torch.Tensor, ref: torch.Tensor, coriolis_f: torch.Tensor, obs_specs,
                         with_clip: bool = True, constants: PhysicalConstants = DEFAULT_CONSTANTS,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the v4 residual-sum kernel: six float32 sums."""
    primal, tang = decode_jvp_v4_ref(fw, pe, dpe, cd_pe, ref, compute_dtype)
    return residual_point_terms(primal, tang, coriolis_f, obs_specs, with_clip, constants).sum(1)


@torch.no_grad()
def residual_sums_v6_ref(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                         ref: torch.Tensor, coriolis_f: torch.Tensor, obs_specs,
                         with_clip: bool = True, constants: PhysicalConstants = DEFAULT_CONSTANTS,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the v6 residual-sum kernel: six float32 sums."""
    primal, tang = decode_jvp_v6_ref(fw, trig, cd_pe, ref, compute_dtype)
    return residual_point_terms(primal, tang, coriolis_f, obs_specs, with_clip, constants).sum(1)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library; declare its C signatures."""
    from deepphysinet_tpu_torch.ops.cuda_build import load_library

    lib = load_library(SOURCE)
    vp = ctypes.c_void_p
    lib.dpn_residual_sums.argtypes = ([ctypes.c_int] + [vp] * 18 + [ctypes.POINTER(_ResidualParams)]
                                      + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp])
    for fn, argtypes in ((lib.dpn_residual_sums, None), (lib.dpn_residual_sums_hid, []),
                         (lib.dpn_residual_sums_block, [ctypes.c_int]),
                         (lib.dpn_residual_sums_shared_bytes, [ctypes.c_int] * 3)):
        if argtypes is not None:
            fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for fn in (lib.dpn_residual_sums_scratch_floats, lib.dpn_residual_sums_tickets):
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int64], ctypes.c_int64
    return lib


def scratch_bytes(n: int, compute_dtype=torch.bfloat16) -> int:
    """Device bytes of a launch's scratch at n points: the partial sums, in bfloat16 also the
    decode outputs [24, n] (float32), and the tickets."""
    lib, is_bf16 = _library(), int(compute_dtype == torch.bfloat16)
    return 4 * (lib.dpn_residual_sums_scratch_floats(is_bf16, n) + lib.dpn_residual_sums_tickets(is_bf16, n))


def _params(obs_specs, with_clip: bool, c: PhysicalConstants) -> _ResidualParams:
    stds, means, bounds = _norm_constants(obs_specs, with_clip)
    f6, i6 = ctypes.c_float * 6, ctypes.c_int * 6
    return _ResidualParams(
        std=f6(*stds), mean=f6(*means), lo=f6(*(b[0] if b else 0.0 for b in bounds)),
        hi=f6(*(b[1] if b else 0.0 for b in bounds)), clip=i6(*(int(b is not None) for b in bounds)),
        c_p=c.c_p, r_d=c.r_d, latent_heat=c.latent_heat, eps_rho=c.eps_rho,
        cp_rv=c.c_p * c.r_v, latent_heat_sq=c.latent_heat**2)


def _residual_sums(wrapper, fw, matrices: Tuple[torch.Tensor, torch.Tensor], pe: torch.Tensor, pe_shape,
                   dpe, cd_pe: torch.Tensor, ref: torch.Tensor, coriolis_f: torch.Tensor, obs_specs,
                   with_clip: bool, constants: PhysicalConstants, compute_dtype, v6: bool) -> torch.Tensor:
    """Checks and the launch shared by the two wrappers (CUDA tensors only)."""
    name = wrapper.__name__
    if pe.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pe.device}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} not supported")
    prm = _params(obs_specs, with_clip, constants)
    lib = _library()
    is_bf16 = int(compute_dtype == torch.bfloat16)
    n_vars, hid = fw.b1.shape
    n, in_ch = cd_pe.shape
    if n_vars != len(FIELD_KEYS) or hid != lib.dpn_residual_sums_hid() or in_ch % 192:
        raise ValueError(f"{name}: kernel built for six variables, hidden {lib.dpn_residual_sums_hid()} and "
                         f"three tangent operands of a multiple of 64 lanes; got {n_vars} variables, "
                         f"hidden {hid}, in_ch {in_ch}")
    smem = lib.dpn_residual_sums_shared_bytes(is_bf16, in_ch, int(v6))
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: in_ch {in_ch} needs {smem} bytes of shared memory")
    cd, f32 = compute_dtype, torch.float32
    ref_t = ref.to(f32).t().contiguous()  # [6, N]: one variable's values side by side
    f_row = coriolis_f.to(f32).reshape(-1).contiguous()
    rows = [("pe", pe, pe_shape, cd), ("cd_pe", cd_pe, (n, in_ch), cd), ("ref", ref_t, (n_vars, n), f32),
            ("coriolis_f", f_row, (n,), f32)]
    if dpe is not None:
        rows.append(("dpe", dpe, (3, n, in_ch // 3), cd))
    for nm, t, shape, dtype in rows:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: {nm} is {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}")
    weights = [m.to(cd) for m in matrices] + [
        getattr(fw, k).to(cd if k in ("w2f1", "wdf1") else f32) for k in _FWD_WEIGHTS]
    weights = [w.detach().contiguous() for w in weights]
    for t in [r[1] for r in rows] + weights:
        if t.device != pe.device:
            raise ValueError(f"{name}: tensors on {t.device} and {pe.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    sums = torch.zeros(len(EQUATIONS), dtype=f32, device=pe.device)
    if n == 0:
        return sums
    # the launch's scratch: the blocks' partial sums (and in bfloat16 the decode outputs) and tickets
    partials = torch.empty(lib.dpn_residual_sums_scratch_floats(is_bf16, n), dtype=f32, device=pe.device)
    tickets = torch.zeros(lib.dpn_residual_sums_tickets(is_bf16, n), dtype=torch.int32, device=pe.device)
    _launch(name, wrapper, lib.dpn_residual_sums, compute_dtype,
            [pe, pe if dpe is None else dpe, cd_pe, ref_t, f_row] + weights + [partials, tickets, sums],
            (ctypes.byref(prm), n, in_ch, int(v6)), pe.device)
    return sums


def fused_residual_sums_v4(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                           cd_pe: torch.Tensor, ref: torch.Tensor, coriolis_f: torch.Tensor, obs_specs,
                           with_clip: bool = True, constants: PhysicalConstants = DEFAULT_CONSTANTS,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-equation squared-residual sums [6] over all N points, in one launch.

    ``pe`` / ``cd_pe`` [N, in_ch] and ``dpe`` [3, N, in_ch//3] are cast to
    ``compute_dtype``; ``ref`` [N, 6] normalized conditioning values and
    ``coriolis_f`` [N, 1].  Equation order ``EQUATIONS``; divide by N for the MSE
    of the split path.  CPU tensors take ``residual_sums_v4_ref``; a CUDA tensor
    launches the kernel or raises.  ``fused_residual_sums_v4.launches`` counts
    kernel launches."""
    cd = compute_dtype
    pe, dpe, cd_pe = pe.to(cd).contiguous(), dpe.to(cd).contiguous(), cd_pe.to(cd).contiguous()
    if pe.device.type == "cpu":
        return residual_sums_v4_ref(fw, pe, dpe, cd_pe, ref, coriolis_f, obs_specs, with_clip,
                                    constants, cd)
    return _residual_sums(fused_residual_sums_v4, fw, (fw.w1, fw.w1c), pe, tuple(cd_pe.shape), dpe, cd_pe,
                          ref, coriolis_f, obs_specs, with_clip, constants, cd, v6=False)


def fused_residual_sums_v6(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                           ref: torch.Tensor, coriolis_f: torch.Tensor, obs_specs,
                           with_clip: bool = True, constants: PhysicalConstants = DEFAULT_CONSTANTS,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The v6 form of ``fused_residual_sums_v4``: ``trig`` [3, N, 2F] (``trig3_inputs``)
    in place of ``pe`` and ``dpe``.  CPU tensors take ``residual_sums_v6_ref``.
    ``fused_residual_sums_v6.launches`` counts kernel launches."""
    cd = compute_dtype
    trig, cd_pe = trig.to(cd).contiguous(), cd_pe.to(cd).contiguous()
    if trig.device.type == "cpu":
        return residual_sums_v6_ref(fw, trig, cd_pe, ref, coriolis_f, obs_specs, with_clip, constants, cd)
    n, in_ch = cd_pe.shape
    n_vars, _, two_f, hid = fw.w1t.shape
    return _residual_sums(fused_residual_sums_v6, fw, (fw.w1g.reshape(n_vars, 3 * two_f, hid), fw.w1t),
                          trig, (3, n, in_ch // 3), None, cd_pe, ref, coriolis_f, obs_specs, with_clip,
                          constants, cd, v6=True)


fused_residual_sums_v4.launches = 0
fused_residual_sums_v6.launches = 0


@torch.no_grad()
def kernel_residual_losses(
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
    """Drop-in for ``engine.fused_kernel_fields`` + ``residual_losses_from_fields`` on
    the forward-only path (MSE criterion): the same seven losses, one kernel launch.

    ``version=6`` runs the v6 layer 1 (``fused_residual_sums_v6``), any other the
    v4 layer 1 (``fused_residual_sums_v4``), as in the JAX package."""
    cdt = model.compute_dtype
    weights = extract_decode_weights(model, tokens, fore_h)
    cd_freqs = make_freq_bands(model.net_cfg["in_channels"] // 2 // 6, max_freq=4.0)
    cd_pe = sinecos_pe(coord_data, cd_freqs, include_input=False)
    fw = fuse_decode_weights(weights)
    if version == 6:
        trig = trig3_inputs(coords, coord_spec, dtype=cdt)
        sums = fused_residual_sums_v6(fuse_v6_from_v4(fw, coord_spec), trig, cd_pe, coord_data, coriolis_f,
                                      obs_specs, with_clip=with_clip, constants=constants, compute_dtype=cdt)
    else:
        pe, dpe = pe_and_tangents(coords, coord_spec, dtype=cdt)
        sums = fused_residual_sums_v4(fw, pe, dpe, cd_pe, coord_data, coriolis_f, obs_specs,
                                      with_clip=with_clip, constants=constants, compute_dtype=cdt)
    mse = sums / float(coords.shape[0])
    losses = {
        "montion_u_loss": mse[0] * loss_factor["motion_u_factor"],
        "montion_v_loss": mse[1] * loss_factor["motion_v_factor"],
        "continous_loss": mse[2] * loss_factor["continuous_factor"],
        "energy_loss": mse[3] * loss_factor["energy_factor"],
        "vapor_loss": mse[4] * loss_factor["vapor_factor"],
        "gas_loss": mse[5] * loss_factor["gas_factor"],
    }
    losses["total"] = (losses["montion_u_loss"] + losses["montion_v_loss"] + losses["energy_loss"]
                       + losses["continous_loss"] + losses["vapor_loss"] + losses["gas_loss"])
    return losses
