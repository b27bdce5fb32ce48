"""Collapsed decode: per-window weight fusion and the Hopper kernels.

Counterpart of the parts of ``deepphysinet_tpu/ops/decode_kernel.py`` that the
inference path and the flagship training step run:

* ``DecodeWeights`` / ``extract_decode_weights`` (:59-115): the effective
  decode weights of one window, generated from the encoder tokens (float32
  einsums, unlike VariableNet's compute-dtype dense layers);
* ``FusedDecodeWeights`` / ``fuse_decode_weights`` (:480-525): the collapsed
  v4 algebra, which folds the trunk's second layer and the scalar head into
  per-window matrices, with the channel-sliced tangent rows ``w1c``
  (``slice_tangent_weights``, :158);
* ``pe_and_tangents`` (:118-155) and ``pe_primal``, its primal half;
* ``decode_primal_v4t``: the var-major primal decode, backed by the CUDA
  kernel ``csrc/decode_primal.cu`` on GPU tensors and by its plain version
  ``decode_primal_v4t_ref`` (a mirror of ``decode_xla_v4t_primal``,
  :1053-1082) on CPU tensors;
* the v4s pair of the training step (:2341-2722): ``trig_cm_inputs``,
  ``FusedDecodeWeightsV6`` / ``fuse_v6_from_v4``, the forward
  ``fused_decode_jvp_v4s`` (``csrc/decode_jvp_v4s.cu``; plain version
  ``decode_jvp_v4s_ref``), the backward ``decode_bwd_kernel_v4s``
  (``csrc/decode_bwd_v4s.cu``; plain version ``decode_bwd_v4s_ref``) and
  ``FusedDecodeJvpV4s``, the ``torch.autograd.Function`` that joins them;
* the v4 / v4t pair of the evaluation sweeps and of the ``kernel_version=4``
  step (:643-918, :1408-1783): the forward ``fused_decode_jvp_v4`` ([N, 6]
  outputs) and ``fused_decode_jvp_v4t`` ([6, N]), both ``csrc/decode_jvp_v4.cu``
  (plain version ``decode_jvp_v4_ref``); the backward ``decode_bwd_kernel_v4``
  and ``decode_bwd_kernel_v4t``, both ``csrc/decode_bwd_v4.cu`` (plain version
  ``decode_bwd_v4_ref``); and ``FusedDecodeJvpV4``, the
  ``torch.autograd.Function`` behind ``fused_decode_jvp_v4_kbwd`` and
  ``fused_decode_jvp_v4t_kbwd``.  The TPU's software-pipelined body
  ``_decode_kernel_v4t_pipe`` is the same arithmetic with its instructions in another order, so
  the one CUDA forward kernel stands for it too and the wrappers take no
  ``pipeline`` option;
* the v6 pair of ``kernel_version=6`` (:1901-2321): ``trig3_inputs``,
  ``fuse_decode_weights_v6``, the forward ``fused_decode_jvp_v6`` (plain version
  ``decode_jvp_v6_ref``), the backward ``decode_bwd_kernel_v6`` (plain version
  ``decode_bwd_v6_ref``) and ``FusedDecodeJvpV6`` behind
  ``fused_decode_jvp_v6_kbwd``.  The v6 pair has the algebra and the fused weights
  of the v4s pair and differs in where the operand lies (``trig [3, N, 2F]``,
  direction-major) and where the results go (``[N, 6]``, ``[3, N, 6]``), so each
  pass shares its CUDA source with v4s (``csrc/decode_jvp_v4s.cu``,
  ``csrc/decode_bwd_v4s.cu``) under an operand-layout flag;
* the four forward-only variants (:166-478, :1117-1407).  v2, the round-1 decode
  without the collapse (``DecodeWeights``): ``fused_decode_jvp``
  (``csrc/decode_jvp_v2.cu``; plain version ``decode_jvp_v2_ref``) and
  ``FusedDecodeJvpV2`` behind ``fused_decode_jvp_trainable``, the kernel forward
  with the plain version's gradient, since the TPU has no v2 backward kernel
  either.  v3, the same chain with the PE computed in the kernel from raw
  coordinates: ``fused_decode_jvp_v3`` (the same source with the front end of
  ``csrc/decode_pe.cuh``; plain version ``decode_jvp_v3_ref`` over
  ``pe_front_end``).  v4pe, the v4 chain behind that front end, and v5, the v4
  function with one sum in another order: ``fused_decode_jvp_v4pe`` and
  ``fused_decode_jvp_v5``, compile-time variants of ``csrc/decode_jvp_v4.cu``
  (plain versions ``decode_jvp_v4pe_ref`` and ``decode_jvp_v5_ref``).

Every wrapper picks by device: a CUDA tensor launches the kernel or raises, a
CPU tensor takes the plain version.  Each wrapper counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.ops.precision import dot_f32

SOURCE = "decode_primal.cu"
SOURCE_JVP_V4S = "decode_jvp_v4s.cu"
SOURCE_BWD_V4S = "decode_bwd_v4s.cu"
SOURCE_JVP_V4 = "decode_jvp_v4.cu"
SOURCE_BWD_V4 = "decode_bwd_v4.cu"
SOURCE_JVP_V2 = "decode_jvp_v2.cu"
SOURCES = (SOURCE, SOURCE_JVP_V4S, SOURCE_BWD_V4S, SOURCE_JVP_V4, SOURCE_BWD_V4, SOURCE_JVP_V2)


class DecodeWeights(NamedTuple):
    """Stacked per-variable decode weights; generated parts depend on tokens."""

    w1: torch.Tensor  # [6, in_ch, hid] generated layer 1
    b1: torch.Tensor  # [6, hid]
    w2: torch.Tensor  # [6, hid, hid] generated layer 2
    b2: torch.Tensor  # [6, hid]
    wd: torch.Tensor  # [6, in_ch, hid] data_input_fc
    bd: torch.Tensor  # [6, hid]
    fh_add: torch.Tensor  # [6, hid] forecast-hour contribution
    f1: torch.Tensor  # [6, hid, hid] trunk fc1
    g1: torch.Tensor  # [6, hid]
    f2: torch.Tensor  # [6, hid, hid] trunk fc2
    g2: torch.Tensor  # [6, hid]
    wo: torch.Tensor  # [6, hid] scalar head
    bo: torch.Tensor  # [6]


def extract_decode_weights(model, tokens: torch.Tensor, fore_h: torch.Tensor) -> DecodeWeights:
    """Materialize the effective decode weights of one window.

    ``model`` is a ``PhysicsNet``; ``tokens`` [T, D] its encoder output for the
    window; ``fore_h`` [1] the normalized forecast lead."""
    nets = model.variable_nets()
    net_cfg = model.net_cfg
    token_num = net_cfg["learnable_token_num"]
    in_ch = net_cfg["in_channels"]
    hid = net_cfg["hidden_channels"]

    def stacked(get):
        return torch.stack([get(net) for net in nets])

    meta_t = tokens[0:token_num].float().t()  # [d_model, token_num]

    k1 = stacked(lambda n: n.coord_input_fc.kernel())
    gen1 = torch.einsum("dt,vtk->vdk", meta_t, k1) + stacked(lambda n: n.coord_input_fc.bias)[:, None, :]
    k2 = stacked(lambda n: n.coord_hidden_fc.kernel())
    gen2 = torch.einsum("dt,vtk->vdk", meta_t, k2) + stacked(lambda n: n.coord_hidden_fc.bias)[:, None, :]

    fh_freqs = make_freq_bands(in_ch // 2, max_freq=4.0)
    fh_pe = sinecos_pe(fore_h.reshape(-1), fh_freqs)  # [in_ch]
    fh_add = (torch.einsum("i,vio->vo", fh_pe, stacked(lambda n: n.fore_h_fc.kernel()))
              + stacked(lambda n: n.fore_h_fc.bias))

    return DecodeWeights(
        w1=gen1[..., :in_ch].transpose(1, 2), b1=gen1[..., in_ch],
        w2=gen2[..., :hid].transpose(1, 2), b2=gen2[..., hid],
        wd=stacked(lambda n: n.data_input_fc.kernel()),
        bd=stacked(lambda n: n.data_input_fc.bias),
        fh_add=fh_add,
        f1=stacked(lambda n: n.cat_fc1.fc[0].kernel()), g1=stacked(lambda n: n.cat_fc1.fc[0].bias),
        f2=stacked(lambda n: n.cat_fc1.fc[2].kernel()), g2=stacked(lambda n: n.cat_fc1.fc[2].bias),
        wo=stacked(lambda n: n.out_fc.kernel()[:, 0]), bo=stacked(lambda n: n.out_fc.bias[0]),
    )


class FusedDecodeWeights(NamedTuple):
    """Algebraically collapsed decode weights (v4).

    Each VariableNet ends in a scalar head, so the trunk output
    y = F2(relu(F1 c)) + 2c is only consumed as y . wo.  Per window:

        r = p @ (w2 f1) + cd_pe @ (wd f1) + rbias
        o = relu(r) . (f2 wo) + 2 (p . (w2 wo) + cd_pe . (wd wo)) + obias
    """

    w1: torch.Tensor  # [6, in_ch, hid] generated layer 1
    w1c: torch.Tensor  # [6, 3, in_ch//3, hid] channel-sliced tangent rows of w1
    b1: torch.Tensor  # [6, hid]
    w2f1: torch.Tensor  # [6, hid, hid] = w2 @ f1
    wdf1: torch.Tensor  # [6, in_ch, hid] = wd @ f1
    rbias: torch.Tensor  # [6, hid] = (b2 + bd + fh_add) @ f1 + g1
    fw2: torch.Tensor  # [6, hid] = f2 @ wo
    w2wo: torch.Tensor  # [6, hid] = w2 @ wo
    wdwo: torch.Tensor  # [6, in_ch] = wd @ wo
    obias: torch.Tensor  # [6] = g2.wo + 2 (b2 + bd + fh_add).wo + bo


def slice_tangent_weights(w1: torch.Tensor) -> torch.Tensor:
    """Channel-sliced rows of the generated layer-1 weights for the sparse
    tangent products: [6, in_ch, hid] -> [6, 3, in_ch//3, hid], where slice k
    holds rows k, k+3, k+6, ... (feature index = f*6 + s*3 + c)."""
    return torch.stack([w1[:, k::3, :] for k in range(3)], dim=1)


def fuse_decode_weights(w: DecodeWeights) -> FusedDecodeWeights:
    """Per-window float32 weight fusion for the collapsed decode."""
    cbias = w.b2 + w.bd + w.fh_add  # [6, hid] constant part of c
    return FusedDecodeWeights(
        w1=w.w1,
        w1c=slice_tangent_weights(w.w1),
        b1=w.b1,
        w2f1=torch.einsum("vij,vjk->vik", w.w2, w.f1),
        wdf1=torch.einsum("vij,vjk->vik", w.wd, w.f1),
        rbias=torch.einsum("vj,vjk->vk", cbias, w.f1) + w.g1,
        fw2=torch.einsum("vjk,vk->vj", w.f2, w.wo),
        w2wo=torch.einsum("vjk,vk->vj", w.w2, w.wo),
        wdwo=torch.einsum("vjk,vk->vj", w.wd, w.wo),
        obias=torch.einsum("vk,vk->v", w.g2, w.wo)
        + 2.0 * torch.einsum("vk,vk->v", cbias, w.wo)
        + w.bo,
    )


def coord_scales(coord_spec, device=None) -> torch.Tensor:
    """d(normalized coord)/d(physical coord) for (x, y, t) -- [3] float32."""
    return torch.tensor(
        [1.0 / (coord_spec.dx * (coord_spec.lon_size - 1)),
         1.0 / (coord_spec.dy * (coord_spec.lat_size - 1)),
         1.0 / coord_spec.pred_t_span], dtype=torch.float32, device=device)


def _pe_sin_cos(coords: torch.Tensor, coord_spec):
    """sin and cos [N, F, 3] of the PE angles, the frequencies [F] and the scales [3].

    Normalizes with the product ``coords * scales`` (not ``encode_coord``'s
    divisions), so the angles round the same way as on the JAX decode path."""
    scales = coord_scales(coord_spec, coords.device)
    cn = coords.float() * scales  # [N, 3] normalized
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=torch.float32, device=coords.device)
    xf = (cn[..., :, None] * fb).transpose(-1, -2)  # [N, F, 3]
    return torch.sin(xf), torch.cos(xf), fb, scales


def pe_primal(coords: torch.Tensor, coord_spec, dtype=torch.float32) -> torch.Tensor:
    """SineCos PE of physical (x, y, t) [N, 3] -> [N, 2F*3] in ``dtype``: the
    primal half of ``pe_and_tangents``."""
    sin, cos, _, _ = _pe_sin_cos(coords, coord_spec)
    return torch.stack([sin, cos], dim=-2).reshape(coords.shape[0], -1).to(dtype)


def pe_and_tangents(coords: torch.Tensor, coord_spec,
                    dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """SineCos PE of physical (x, y, t) and its three directional derivatives.

    Closed form: feature (freq f, sin | cos, channel c) differentiates to
    ``f cos`` | ``-f sin`` times the channel's normalization scale.  Direction k
    touches only the channel-k features (a third of them), so the tangents are
    compact: ``(pe [N, 2F*3], dpe [3, N, 2F])``, ordered (freq, sin | cos) to
    match the rows of ``slice_tangent_weights``."""
    sin, cos, fb, scales = _pe_sin_cos(coords, coord_spec)
    pe = torch.stack([sin, cos], dim=-2).reshape(coords.shape[0], -1)
    dfeat = torch.stack([cos * fb[None, :, None], -sin * fb[None, :, None]], dim=-2)  # [N, F, 2, 3]
    dpe = torch.movedim(dfeat, -1, 0) * scales[:, None, None, None]  # [3, N, F, 2]
    return pe.to(dtype), dpe.reshape(3, coords.shape[0], -1).to(dtype).contiguous()


def decode_primal_v4t_ref(fw: FusedDecodeWeights, pe: torch.Tensor, cd_pe: torch.Tensor,
                          ref_t: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [6, N] normalized outputs.

    Row for row ``decode_xla_v4t_primal``: matmul inputs rounded to the
    compute dtype with float32 products; p stays float32 for the w2wo sum."""
    cdt = compute_dtype
    rows = []
    for v in range(fw.w1.shape[0]):
        p = torch.relu(dot_f32(pe, fw.w1[v], cdt) + fw.b1[v])
        r = dot_f32(p, fw.w2f1[v], cdt) + dot_f32(cd_pe, fw.wdf1[v], cdt) + fw.rbias[v]
        o = ((torch.relu(r) * fw.fw2[v]).sum(-1)
             + 2.0 * ((p * fw.w2wo[v]).sum(-1) + (cd_pe.float() * fw.wdwo[v]).sum(-1))
             + fw.obias[v] + ref_t[v])
        rows.append(o)
    return torch.stack(rows, 0)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library; declare its C signatures."""
    from deepphysinet_tpu_torch.ops.cuda_build import load_library

    lib = load_library(SOURCE)
    vp = ctypes.c_void_p
    lib.dpn_decode_primal_v4t.argtypes = [ctypes.c_int] + [vp] * 13 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp]
    lib.dpn_decode_primal_v4t.restype = ctypes.c_int
    for fn in (lib.dpn_decode_primal_hid, lib.dpn_decode_primal_k_tile):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.dpn_decode_primal_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dpn_decode_primal_shared_bytes.restype = ctypes.c_int
    lib.dpn_decode_primal_block.argtypes = [ctypes.c_int]
    lib.dpn_decode_primal_block.restype = ctypes.c_int
    return lib


# The shared memory a Hopper block may use; each kernel's library says what it needs.
_MAX_SHARED_BYTES = 232448


def decode_primal_v4t(fw: FusedDecodeWeights, pe: torch.Tensor, cd_pe: torch.Tensor,
                      ref_t: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Var-major primal decode [6, N]: the CUDA kernel on GPU tensors.

    ``pe`` / ``cd_pe`` [N, in_ch] in ``compute_dtype``, ``ref_t`` [6, N]
    float32.  CPU tensors take ``decode_primal_v4t_ref``; a CUDA tensor
    launches the kernel or raises.  ``decode_primal_v4t.launches`` counts
    kernel launches."""
    if pe.device.type == "cpu":
        return decode_primal_v4t_ref(fw, pe, cd_pe, ref_t, compute_dtype)
    if pe.device.type != "cuda":
        raise ValueError(f"decode_primal_v4t: no kernel for device {pe.device}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_primal_v4t: compute dtype {compute_dtype} not supported")
    n_vars, in_ch, hid = fw.w1.shape
    n = pe.shape[0]
    lib = _library()
    if hid != lib.dpn_decode_primal_hid() or in_ch % lib.dpn_decode_primal_k_tile():
        raise ValueError(f"decode_primal_v4t: kernel built for hidden {lib.dpn_decode_primal_hid()} "
                         f"and in_ch a multiple of {lib.dpn_decode_primal_k_tile()}; "
                         f"got hidden {hid}, in_ch {in_ch}")
    smem = lib.dpn_decode_primal_shared_bytes(int(compute_dtype == torch.bfloat16), in_ch)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"decode_primal_v4t: in_ch {in_ch} needs {smem} bytes of shared memory")
    for name, t, shape, dtype in (("pe", pe, (n, in_ch), compute_dtype),
                                  ("cd_pe", cd_pe, (n, in_ch), compute_dtype),
                                  ("ref_t", ref_t, (n_vars, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"decode_primal_v4t: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")

    cd, f32 = compute_dtype, torch.float32
    weights = [fw.w1.to(cd), fw.b1.to(f32), fw.w2f1.to(cd), fw.wdf1.to(cd), fw.rbias.to(f32),
               fw.fw2.to(f32), fw.w2wo.to(f32), fw.wdwo.to(f32), fw.obias.to(f32)]
    weights = [w.contiguous() for w in weights]
    args = [pe, cd_pe, ref_t]
    for t in args + weights:
        if t.device != pe.device:
            raise ValueError(f"decode_primal_v4t: tensors on {t.device} and {pe.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_primal_v4t: inputs must be contiguous and 16-byte aligned")
    w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias = weights
    out = torch.empty((n_vars, n), dtype=f32, device=pe.device)
    if n == 0:
        return out
    with torch.cuda.device(pe.device):
        stream = torch.cuda.current_stream(pe.device).cuda_stream
        err = lib.dpn_decode_primal_v4t(
            int(cd == torch.bfloat16), pe.data_ptr(), cd_pe.data_ptr(), ref_t.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2f1.data_ptr(), wdf1.data_ptr(), rbias.data_ptr(),
            fw2.data_ptr(), w2wo.data_ptr(), wdwo.data_ptr(), obias.data_ptr(), out.data_ptr(),
            n, in_ch, n_vars, stream)
    if err != 0:
        raise RuntimeError(f"decode_primal_v4t: CUDA error {err} at launch")
    decode_primal_v4t.launches += 1
    return out


decode_primal_v4t.launches = 0


# ---------------------------------------------------------------------------
# v4s: the decode pair of the training step.  The per-point operand is the
# channel-major trig row [N, 3*2F]; the primal consumes the whole row through
# the permuted layer-1 weights and direction k's tangent consumes lanes
# k*2F:(k+1)*2F of the same row through weights that carry the PE derivative
# (d/dcn sin(f cn) = f cos(f cn): a swap, a sign and a scale of the primal rows).
# ---------------------------------------------------------------------------


def channel_major_perm(in_ch: int, n_channels: int) -> np.ndarray:
    """Permutation taking interleaved PE features (index = (f*2+s)*C + c) to
    channel-major order [c][all sin(f), then all cos(f)]."""
    n_freqs = in_ch // (2 * n_channels)
    perm = []
    for c in range(n_channels):
        perm.extend((2 * f) * n_channels + c for f in range(n_freqs))  # sin rows
        perm.extend((2 * f + 1) * n_channels + c for f in range(n_freqs))  # cos rows
    return np.asarray(perm)


def trig_cm_inputs(coords: torch.Tensor, coord_spec, dtype=torch.float32) -> torch.Tensor:
    """Channel-major trig operand [N, 3*2F] of physical (x, y, t) [N, 3].

    Block c (lanes ``c*2F : (c+1)*2F``) holds ``[sin(fb * cn_c) | cos(fb * cn_c)]``,
    the row order of ``channel_major_perm``."""
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=torch.float32, device=coords.device)
    cn = coords.float() * coord_scales(coord_spec, coords.device)  # [N, 3]
    xf = cn[:, :, None] * fb  # [N, 3, F]
    out = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # [N, 3, 2F]
    return out.reshape(cn.shape[0], -1).to(dtype)


class FusedDecodeWeightsV6(NamedTuple):
    """The collapsed weights with layer 1 re-expressed over trig inputs."""

    w1g: torch.Tensor  # [6, 3, 2F, hid] channel-major primal layer-1 rows
    w1t: torch.Tensor  # [6, 3, 2F, hid] tangent rows (swap, sign, fb and scale folded in)
    b1: torch.Tensor  # [6, hid]
    w2f1: torch.Tensor  # [6, hid, hid]
    wdf1: torch.Tensor  # [6, in_ch, hid]
    rbias: torch.Tensor  # [6, hid]
    fw2: torch.Tensor  # [6, hid]
    w2wo: torch.Tensor  # [6, hid]
    wdwo: torch.Tensor  # [6, in_ch]
    obias: torch.Tensor  # [6]


def fuse_v6_from_v4(fw: FusedDecodeWeights, coord_spec) -> FusedDecodeWeightsV6:
    """Per-window re-expression of the fused weights over trig inputs (differentiable)."""
    n_vars, in_ch, hid = fw.w1.shape
    nf = in_ch // 6
    perm = torch.as_tensor(channel_major_perm(in_ch, 3), device=fw.w1.device)
    w1g = fw.w1[:, perm, :].reshape(n_vars, 3, 2 * nf, hid)
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=torch.float32, device=fw.w1.device)
    coef = (coord_scales(coord_spec, fw.w1.device)[:, None] * fb)[None, :, :, None]  # [1, 3, F, 1]
    w1t = torch.cat([-coef * w1g[:, :, nf:], coef * w1g[:, :, :nf]], dim=2)
    return FusedDecodeWeightsV6(
        w1g=w1g, w1t=w1t, b1=fw.b1, w2f1=fw.w2f1, wdf1=fw.wdf1,
        rbias=fw.rbias, fw2=fw.fw2, w2wo=fw.w2wo, wdwo=fw.wdwo, obias=fw.obias)


def fuse_decode_weights_v6(w: DecodeWeights, coord_spec) -> FusedDecodeWeightsV6:
    """Per-window float32 weight fusion for the trig-input collapsed decode."""
    return fuse_v6_from_v4(fuse_decode_weights(w), coord_spec)


def trig3_inputs(coords: torch.Tensor, coord_spec, dtype=torch.float32) -> torch.Tensor:
    """Direction-major trig blocks [3, N, 2F] of physical (x, y, t) [N, 3], in ``dtype``.

    ``trig[k] = [sin(fb * cn_k) | cos(fb * cn_k)]`` with ``cn`` the normalized
    coordinate: the only per-point prep of the v6 kernels, and the lane blocks of
    ``trig_cm_inputs`` laid out by direction."""
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=torch.float32, device=coords.device)
    cn = coords.float() * coord_scales(coord_spec, coords.device)  # [N, 3]
    xf = cn.t()[:, :, None] * fb  # [3, N, F]
    return torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).to(dtype)


def _dot_t(a: torch.Tensor, b: torch.Tensor, cdt) -> torch.Tensor:
    """``a^T @ b`` over the second-to-last (point) axis, inputs rounded to ``cdt``."""
    return torch.matmul(a.to(cdt).float().transpose(-1, -2), b.to(cdt).float())


class _Layer1(NamedTuple):
    """Layer-1 operands of one jvp decode: what v4, v4s and v6 differ in.

    v4 reads the interleaved PE through ``w1`` and the compact tangents ``dpe[k]``
    through ``w1c[:, k]``; v4s reads the channel-major trig row through ``w1g``
    and its lane block k through ``w1t[:, k]``; v6 reads the same row as three
    direction-major blocks ``trig[k]``.  Everything after layer 1 is the same
    arithmetic."""

    pe: torch.Tensor  # [N, in_ch] primal operand
    w1: torch.Tensor  # [V, in_ch, hid]
    tin: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tangent operands, each [N, ch]
    w1k: torch.Tensor  # [V, 3, ch, hid] tangent rows


def _layer1_v4(fw: FusedDecodeWeights, pe, dpe) -> _Layer1:
    return _Layer1(pe, fw.w1, (dpe[0], dpe[1], dpe[2]), fw.w1c)


def _layer1_v4s(fw: FusedDecodeWeightsV6, pe_cm) -> _Layer1:
    n_vars, _, two_f, hid = fw.w1t.shape
    blocks = tuple(pe_cm[:, k * two_f:(k + 1) * two_f] for k in range(3))
    return _Layer1(pe_cm, fw.w1g.reshape(n_vars, 3 * two_f, hid), blocks, fw.w1t)


def _layer1_v6(fw: FusedDecodeWeightsV6, trig) -> _Layer1:
    """The TPU kernel sums z as three K = 2F products; their concatenation into one
    K = 3 * 2F product is the same sum of the same terms."""
    n_vars, _, two_f, hid = fw.w1t.shape
    return _Layer1(torch.cat([trig[0], trig[1], trig[2]], dim=-1),
                   fw.w1g.reshape(n_vars, 3 * two_f, hid), (trig[0], trig[1], trig[2]), fw.w1t)


def _jvp_ref(l1: _Layer1, fw, cd_pe, ref_t, cdt, round_tangents: bool, split_rbias: bool = False):
    """Var-major plain forward shared by v4, v4s, v6, v5 and v4pe: ([V, N], [3, V, N]) float32.

    ``split_rbias`` sums ``r`` as v5 does, ``p . w2f1 + (cd . wdf1 + rbias)`` (:1149,
    :1156), where the others sum ``(p . w2f1 + cd . wdf1) + rbias`` (:548)."""
    z = dot_f32(l1.pe, l1.w1, cdt) + fw.b1[:, None, :]  # [V, N, hid]
    mask = z > 0
    p = torch.relu(z)
    t = torch.stack([torch.where(mask, dot_f32(l1.tin[k], l1.w1k[:, k], cdt), 0.0)
                     for k in range(3)], dim=0)  # [3, V, N, hid]
    if round_tangents:
        t = t.to(cdt).float()

    if split_rbias:
        rp = dot_f32(p, fw.w2f1, cdt) + (dot_f32(cd_pe, fw.wdf1, cdt) + fw.rbias[:, None, :])
    else:
        rp = dot_f32(p, fw.w2f1, cdt) + dot_f32(cd_pe, fw.wdf1, cdt) + fw.rbias[:, None, :]
    maskr = rp > 0
    pr = torch.relu(rp)
    tr = torch.where(maskr[None], dot_f32(t, fw.w2f1[None], cdt), 0.0)  # [3, V, N, hid]

    o = ((pr * fw.fw2[:, None, :]).sum(-1)
         + 2.0 * ((p * fw.w2wo[:, None, :]).sum(-1)
                  + torch.einsum("nk,vk->vn", cd_pe.float(), fw.wdwo.float()))
         + fw.obias[:, None] + ref_t)  # [V, N]
    to = ((tr * fw.fw2[None, :, None, :]).sum(-1)
          + 2.0 * (t * fw.w2wo[None, :, None, :]).sum(-1))  # [3, V, N]
    return o, to


def _bwd_ref(l1: _Layer1, fw, cd_pe, g_primal_t, g_tang_t, cdt) -> dict:
    """Plain backward shared by v4, v4s and v6: the weights' cotangents by name
    (``w1`` and ``w1k`` for the two layer-1 operands).

    Line for line ``_decode_bwd_kernel_v4`` (:1408-1514) and
    ``_decode_bwd_kernel_v4s`` (:2554-2598) over all points at once: the forward
    chain is recomputed (the tangents stay float32 after masking and are rounded
    only as a product's input), every operand of every product is rounded to the
    compute dtype, and the sums are float32."""
    # ---- recompute the forward chain ----
    z = dot_f32(l1.pe, l1.w1, cdt) + fw.b1[:, None, :]  # [V, N, hid]
    mask = z > 0
    p = torch.relu(z)
    t = torch.stack([torch.where(mask, dot_f32(l1.tin[k], l1.w1k[:, k], cdt), 0.0)
                     for k in range(3)], dim=0)  # [3, V, N, hid]
    w = fw.w2f1
    rp = dot_f32(p, w, cdt) + dot_f32(cd_pe, fw.wdf1, cdt) + fw.rbias[:, None, :]
    maskr = rp > 0
    pr = torch.relu(rp)
    tr = torch.where(maskr[None], dot_f32(t, w[None], cdt), 0.0)

    # ---- backward ----
    go = g_primal_t.float()[:, :, None]  # [V, N, 1]
    gto = g_tang_t.float()[:, :, :, None]  # [3, V, N, 1]
    a_v = fw.fw2.float()[:, None, :]  # [V, 1, hid]
    b_v = fw.w2wo.float()[:, None, :]

    g_rp = torch.where(maskr, go * a_v, 0.0)  # [V, N, hid]
    g_rt = torch.where(maskr[None], gto * a_v[None], 0.0)  # [3, V, N, hid]

    wt = w.transpose(-1, -2)
    g_p = dot_f32(g_rp, wt, cdt) + 2.0 * (go * b_v)
    g_t = dot_f32(g_rt, wt[None], cdt) + 2.0 * (gto * b_v[None])
    g_z = torch.where(mask, g_p, 0.0)
    g_tz = torch.where(mask[None], g_t, 0.0)
    return dict(
        w1=_dot_t(l1.pe, g_z, cdt),  # [V, in_ch, hid]
        w1k=torch.stack([_dot_t(l1.tin[k], g_tz[k], cdt) for k in range(3)], dim=1),
        b1=g_z.sum(1),
        w2f1=_dot_t(p, g_rp, cdt) + _dot_t(t, g_rt, cdt).sum(0),
        wdf1=_dot_t(cd_pe, g_rp, cdt),
        rbias=g_rp.sum(1),
        fw2=(pr * go).sum(1) + (tr * gto).sum((0, 2)),
        w2wo=2.0 * ((p * go).sum(1) + (t * gto).sum((0, 2))),
        wdwo=2.0 * torch.einsum("nk,vn->vk", cd_pe.float(), g_primal_t.float()),
        obias=g_primal_t.float().sum(1))


def decode_jvp_v4s_ref(fw: FusedDecodeWeightsV6, pe_cm: torch.Tensor, cd_pe: torch.Tensor,
                       ref_t: torch.Tensor, compute_dtype=torch.bfloat16,
                       round_tangents: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ([6, N], [3, 6, N]) float32.

    Differentiable.  With ``round_tangents`` (the default) it has the rounding
    points of the kernels, TPU and CUDA alike: the masked tangents are rounded
    to the compute dtype once, and both ``t . w2f1`` and the ``w2wo`` sum read
    the rounded values (``_decode_kernel_v4s``, :2388-2392, :578-579).
    Without it the tangents stay float32 for the ``w2wo`` sum, which is what
    the JAX package's XLA twin ``decode_jvp_xla_v4s`` (:2486-2504) does; the
    two agree exactly when the compute dtype is float32."""
    return _jvp_ref(_layer1_v4s(fw, pe_cm), fw, cd_pe, ref_t, compute_dtype, round_tangents)


@torch.no_grad()
def decode_bwd_v4s_ref(fw: FusedDecodeWeightsV6, pe_cm: torch.Tensor, cd_pe: torch.Tensor,
                       g_primal_t: torch.Tensor, g_tang_t: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> FusedDecodeWeightsV6:
    """Plain PyTorch version of the backward kernel: the fused weights' cotangents
    (``_bwd_ref``).  The ``obias`` slot carries ``sum_N g_primal_t``."""
    g = _bwd_ref(_layer1_v4s(fw, pe_cm), fw, cd_pe, g_primal_t, g_tang_t, compute_dtype)
    g["w1g"], g["w1t"] = g.pop("w1").reshape(fw.w1g.shape), g.pop("w1k")
    return FusedDecodeWeightsV6(**g)


def decode_jvp_v6_ref(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                      ref: torch.Tensor, compute_dtype=torch.bfloat16,
                      round_tangents: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v6 forward kernel: ([N, 6], [3, N, 6]) float32.

    ``trig`` [3, N, 2F] (``trig3_inputs``), ``cd_pe`` [N, in_ch], ``ref`` [N, 6].
    Differentiable.  With ``round_tangents`` (the default) it has the rounding
    points of the kernels (``_v6_var_column``, :1967-1969, and ``_v4_stage2``,
    :578-579): the masked tangents are rounded to the compute dtype once and the
    ``w2wo`` sum reads the rounded values.  Without it the tangents stay float32
    for that sum, as in the JAX package's XLA twin ``decode_jvp_xla_v6``
    (:2092-2093, :2108-2109).  The ``wdwo`` sum reads ``cd_pe`` as it is given:
    the kernels get it in the compute dtype, the twin in float32 from
    ``jvp_fields(version=6)``.  The two roundings agree exactly when the compute
    dtype is float32."""
    o, to = _jvp_ref(_layer1_v6(fw, trig), fw, cd_pe, ref.t(), compute_dtype, round_tangents)
    return o.t(), to.transpose(1, 2)


@torch.no_grad()
def decode_bwd_v6_ref(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                      g_primal: torch.Tensor, g_tang: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> FusedDecodeWeightsV6:
    """Plain PyTorch version of the v6 backward kernel: the fused weights' cotangents.

    ``g_primal`` [N, 6] and ``g_tang`` [3, N, 6].  ``_bwd_ref`` follows
    ``_decode_bwd_kernel_v6`` (:2115-2199), which keeps the recomputed tangents
    float32 where the forward kernel rounds them (the ``fw2`` and ``w2wo`` sums,
    :2164, :2181-2182); ``g_w1g[v, k] = trig_k^T g_z`` is rows ``k * 2F : (k + 1) * 2F``
    of the one product over the concatenated row.  The ``obias`` slot carries
    ``sum_N g_primal``."""
    g = _bwd_ref(_layer1_v6(fw, trig), fw, cd_pe, g_primal.t(), g_tang.transpose(1, 2),
                 compute_dtype)
    g["w1g"], g["w1t"] = g.pop("w1").reshape(fw.w1g.shape), g.pop("w1k")
    return FusedDecodeWeightsV6(**g)


def decode_jvp_v4_ref(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                      cd_pe: torch.Tensor, ref: torch.Tensor, compute_dtype=torch.bfloat16,
                      round_tangents: bool = True,
                      t_layout: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v4 forward kernel, both layouts, float32 out.

    ``pe`` / ``cd_pe`` [N, in_ch] and ``dpe`` [3, N, in_ch//3] (``pe_and_tangents``).
    ``t_layout=False``: ``ref`` [N, 6] -> ``([N, 6], [3, N, 6])``, the form of
    ``fused_decode_jvp_v4``; ``t_layout=True``: ``ref`` [6, N] -> ``([6, N],
    [3, 6, N])``, the form of ``fused_decode_jvp_v4t``.  Differentiable.

    With ``round_tangents`` (the default) it has the rounding points of the
    kernels (``_v4_var_column``, :627-634, and ``_v4_stage2``, :578-579): the
    masked tangents are rounded to the compute dtype once and the ``w2wo`` sum
    reads the rounded values.  Without it the tangents stay float32 for that
    sum, as in the JAX package's XLA twin ``decode_jvp_xla_v4`` (:905, :913);
    the two agree exactly when the compute dtype is float32."""
    o, to = _jvp_ref(_layer1_v4(fw, pe, dpe), fw, cd_pe, ref if t_layout else ref.t(),
                     compute_dtype, round_tangents)
    return (o, to) if t_layout else (o.t(), to.transpose(1, 2))


@torch.no_grad()
def decode_bwd_v4_ref(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                      cd_pe: torch.Tensor, g_primal: torch.Tensor, g_tang: torch.Tensor,
                      compute_dtype=torch.bfloat16, t_layout: bool = False) -> FusedDecodeWeights:
    """Plain PyTorch version of the v4 backward kernel: the fused weights' cotangents.

    ``g_primal`` [N, 6] and ``g_tang`` [3, N, 6], or [6, N] and [3, 6, N] with
    ``t_layout``.  ``_bwd_ref`` follows ``_decode_bwd_kernel_v4`` (:1408-1514),
    which keeps the recomputed tangents float32 where the forward kernel rounds
    them (the ``w2wo`` and ``fw2`` sums, :1494-1495).  ``w1`` and ``w1c`` get
    separate cotangents, as from the TPU kernel: autograd adds them through
    ``slice_tangent_weights``.  The ``obias`` slot carries ``sum_N g_primal``."""
    if not t_layout:
        g_primal, g_tang = g_primal.t(), g_tang.transpose(1, 2)
    g = _bwd_ref(_layer1_v4(fw, pe, dpe), fw, cd_pe, g_primal, g_tang, compute_dtype)
    g["w1c"] = g.pop("w1k")
    return FusedDecodeWeights(**g)


# Per source: its launch functions, each with its number of pointer arguments.  A
# flag follows (n, in_ch, n_vars): the output layout of the v4 pair, v4s against
# v6 for the v4s sources, 0 for the others.  The first name also prefixes the
# source's ``_hid`` and ``_shared_bytes`` queries.
_LAUNCHERS = {
    SOURCE_JVP_V4S: (("dpn_decode_jvp_v4s", 15),),
    SOURCE_BWD_V4S: (("dpn_decode_bwd_v4s", 21),),
    SOURCE_JVP_V4: (("dpn_decode_jvp_v4", 16), ("dpn_decode_jvp_v5", 16), ("dpn_decode_jvp_v4pe", 16)),
    SOURCE_BWD_V4: (("dpn_decode_bwd_v4", 22),),
    SOURCE_JVP_V2: (("dpn_decode_jvp_v2", 21), ("dpn_decode_jvp_v3", 20)),
}


@functools.cache
def _jvp_library(source: str) -> ctypes.CDLL:
    """Build (at first use) and load one of the jvp-family kernels; declare its C signatures."""
    from deepphysinet_tpu_torch.ops.cuda_build import load_library

    lib = load_library(source)
    vp = ctypes.c_void_p
    for name, n_pointers in _LAUNCHERS[source]:
        launch = getattr(lib, name)
        launch.argtypes = ([ctypes.c_int] + [vp] * n_pointers
                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp])
        launch.restype = ctypes.c_int
    for suffix, argtypes in (("_hid", []), ("_shared_bytes", [ctypes.c_int, ctypes.c_int])):
        fn = getattr(lib, _LAUNCHERS[source][0][0] + suffix)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# order of the forward kernels' weight inputs after the layer-1 pair
_FWD_WEIGHTS = ("b1", "w2f1", "wdf1", "rbias", "fw2", "w2wo", "wdwo", "obias")

# rows of one pass of the backward kernels' point contraction; the tangent
# operands (in_ch / 3 lanes each) must be a whole number of passes
_CONTRACTION_ROWS = 64


def _kernel_checks(name: str, source: str, hid: int, in_ch: int, compute_dtype, rows,
                   weights) -> ctypes.CDLL:
    """Checks shared by the jvp-family wrappers; returns the kernel's library.

    ``rows`` are (name, tensor, shape, dtype or None for the compute dtype) of the
    per-point inputs, the first of which names the device; ``weights`` are the
    weights as the kernel reads them."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} not supported")
    lib = _jvp_library(source)
    prefix = _LAUNCHERS[source][0][0]
    built_hid = getattr(lib, prefix + "_hid")()
    if hid != built_hid or in_ch % (3 * _CONTRACTION_ROWS):
        raise ValueError(f"{name}: kernel built for hidden {built_hid} and three tangent operands "
                         f"of a multiple of {_CONTRACTION_ROWS} lanes; got hidden {hid}, in_ch {in_ch}")
    smem = getattr(lib, prefix + "_shared_bytes")(int(compute_dtype == torch.bfloat16), in_ch)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: in_ch {in_ch} needs {smem} bytes of shared memory")
    for nm, t, shape, dtype in rows:
        dtype = dtype or compute_dtype
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: {nm} is {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}")
    device = rows[0][1].device
    for t in [r[1] for r in rows] + list(weights):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    return lib


def _fused_weights(fw, matrices: dict, cd) -> dict:
    """The fused weights as the forward kernels read them, by name: ``matrices`` (the layer-1
    weights, already in the kernel's shape) then ``_FWD_WEIGHTS``."""
    f32 = torch.float32
    weights = {k: w.to(cd) for k, w in matrices.items()}
    weights.update(
        b1=fw.b1.to(f32), w2f1=fw.w2f1.to(cd), wdf1=fw.wdf1.to(cd), rbias=fw.rbias.to(f32),
        fw2=fw.fw2.to(f32), w2wo=fw.w2wo.to(f32), wdwo=fw.wdwo.to(f32), obias=fw.obias.to(f32))
    return {k: w.detach().contiguous() for k, w in weights.items()}


def _jvp_kernel_inputs(name: str, source: str, fw, matrices: dict, pe: torch.Tensor,
                       cd_pe: torch.Tensor, compute_dtype, point_rows,
                       pe_shape=None) -> Tuple[ctypes.CDLL, dict]:
    """Checks shared by the jvp-pair wrappers; returns the library and the contiguous weights.

    ``matrices`` are the layer-1 weights by name, already in the kernel's shape
    (the other weights are taken from ``fw`` by name); ``point_rows`` are
    (name, tensor, shape, dtype or None for the compute dtype) of the per-point
    inputs besides ``pe`` and ``cd_pe``; ``pe_shape`` is the shape of the primal
    operand where it is not ``cd_pe``'s [N, in_ch] (the v6 trig blocks)."""
    n, in_ch = cd_pe.shape
    weights = _fused_weights(fw, matrices, compute_dtype)
    rows = [("pe", pe, pe_shape or (n, in_ch), None), ("cd_pe", cd_pe, (n, in_ch), None)] + list(point_rows)
    return _kernel_checks(name, source, fw.b1.shape[1], in_ch, compute_dtype, rows, weights.values()), weights


def _launch(name: str, wrapper, fn, compute_dtype, tensors, ints, device) -> None:
    """Call the C launcher ``fn`` on the current stream of ``device``; count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(int(compute_dtype == torch.bfloat16), *(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    wrapper.launches += 1


def _zeros_f32(like: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 zeros of ``like``'s shape: a backward kernel's output."""
    return torch.zeros(like.shape, dtype=torch.float32, device=like.device)


def _v4s_matrices(fw: FusedDecodeWeightsV6) -> dict:
    n_vars, _, two_f, hid = fw.w1t.shape
    return dict(w1g=fw.w1g.reshape(n_vars, 3 * two_f, hid), w1t=fw.w1t)


def fused_decode_jvp_v4s(fw: FusedDecodeWeightsV6, pe_cm: torch.Tensor, cd_pe: torch.Tensor,
                         ref_t: torch.Tensor,
                         compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [6, N] and tangents [3, 6, N] (float32): the CUDA kernel on GPU tensors.

    ``pe_cm`` (``trig_cm_inputs``) and ``cd_pe`` [N, in_ch] in ``compute_dtype``,
    ``ref_t`` [6, N] float32.  CPU tensors take ``decode_jvp_v4s_ref``; a CUDA
    tensor launches the kernel or raises.  The kernel's result carries no
    autograd graph: training goes through ``FusedDecodeJvpV4s``.
    ``fused_decode_jvp_v4s.launches`` counts kernel launches."""
    if pe_cm.device.type == "cpu":
        return decode_jvp_v4s_ref(fw, pe_cm, cd_pe, ref_t, compute_dtype)
    if pe_cm.device.type != "cuda":
        raise ValueError(f"fused_decode_jvp_v4s: no kernel for device {pe_cm.device}")
    name = "fused_decode_jvp_v4s"
    n_vars, (n, in_ch) = fw.w1t.shape[0], pe_cm.shape
    lib, w = _jvp_kernel_inputs(name, SOURCE_JVP_V4S, fw, _v4s_matrices(fw), pe_cm, cd_pe,
                                compute_dtype, [("ref_t", ref_t, (n_vars, n), torch.float32)])
    primal = torch.empty((n_vars, n), dtype=torch.float32, device=pe_cm.device)
    tang = torch.empty((3, n_vars, n), dtype=torch.float32, device=pe_cm.device)
    if n == 0:
        return primal, tang
    _launch(name, fused_decode_jvp_v4s, lib.dpn_decode_jvp_v4s, compute_dtype,
            [pe_cm, cd_pe, ref_t, w["w1g"], w["w1t"]] + [w[k] for k in _FWD_WEIGHTS] + [primal, tang],
            (n, in_ch, n_vars, 0), pe_cm.device)
    return primal, tang


fused_decode_jvp_v4s.launches = 0

# order of the backward kernels' weight inputs after the layer-1 pair and of their
# outputs (every backward kernel reads W^T from w2f1 itself)
_BWD_WEIGHTS = ("b1", "w2f1", "wdf1", "rbias", "fw2", "w2wo")
_BWD_OUTPUTS = ("b1", "w2f1", "wdf1", "rbias", "fw2", "w2wo", "wdwo")


def decode_bwd_kernel_v4s(fw: FusedDecodeWeightsV6, pe_cm: torch.Tensor, cd_pe: torch.Tensor,
                          g_primal_t: torch.Tensor, g_tang_t: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> FusedDecodeWeightsV6:
    """Weight cotangents of ``fused_decode_jvp_v4s``: the CUDA kernel on GPU tensors.

    ``g_primal_t`` [6, N] and ``g_tang_t`` [3, 6, N] float32.  The ``obias``
    slot carries ``sum_N g_primal_t``, a ``torch.sum`` outside the kernel.  CPU
    tensors take ``decode_bwd_v4s_ref``; a CUDA tensor launches the kernel or
    raises.  The kernel sums across blocks with atomic adds, so its result is
    not bit-reproducible from run to run.
    ``decode_bwd_kernel_v4s.launches`` counts kernel launches."""
    if pe_cm.device.type == "cpu":
        return decode_bwd_v4s_ref(fw, pe_cm, cd_pe, g_primal_t, g_tang_t, compute_dtype)
    if pe_cm.device.type != "cuda":
        raise ValueError(f"decode_bwd_kernel_v4s: no kernel for device {pe_cm.device}")
    name = "decode_bwd_kernel_v4s"
    n_vars, (n, in_ch) = fw.w1t.shape[0], pe_cm.shape
    lib, w = _jvp_kernel_inputs(name, SOURCE_BWD_V4S, fw, _v4s_matrices(fw), pe_cm, cd_pe,
                                compute_dtype, [("g_primal_t", g_primal_t, (n_vars, n), torch.float32),
                                                ("g_tang_t", g_tang_t, (3, n_vars, n), torch.float32)])
    out = FusedDecodeWeightsV6(*(
        g_primal_t.sum(1) if k == "obias" else _zeros_f32(t)
        for k, t in zip(fw._fields, fw)))
    if n == 0:
        return out
    _launch(name, decode_bwd_kernel_v4s, lib.dpn_decode_bwd_v4s, compute_dtype,
            [pe_cm, cd_pe, g_primal_t, g_tang_t, w["w1g"], w["w1t"]] + [w[k] for k in _BWD_WEIGHTS]
            + [out.w1g, out.w1t] + [getattr(out, k) for k in _BWD_OUTPUTS],
            (n, in_ch, n_vars, 0), pe_cm.device)
    return out


decode_bwd_kernel_v4s.launches = 0


class FusedDecodeJvpV4s(torch.autograd.Function):
    """The v4s decode with a kernel on both passes (the training hot path).

    ``FusedDecodeJvpV4s.apply(pe_cm, cd_pe, ref_t, compute_dtype, *fw)`` with
    ``fw`` a ``FusedDecodeWeightsV6`` returns ``(primal_t [6, N], tang_t
    [3, 6, N])``.  The contract of ``fused_decode_jvp_v4s_kbwd`` (:2678-2722):
    exact cotangents for the ten fused weights, ``g_ref_t = g_primal_t``,
    ``g_obias = sum_N g_primal_t``, and zeros for ``pe_cm`` and ``cd_pe``, which
    are functions of data only in the training engine.  Saved for backward:
    the fused weights, ``pe_cm`` and ``cd_pe``; no activations (the backward
    kernel recomputes them).  First derivatives only."""

    @staticmethod
    def forward(ctx, pe_cm, cd_pe, ref_t, compute_dtype, *fw):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(pe_cm, cd_pe, *fw)
        return fused_decode_jvp_v4s(FusedDecodeWeightsV6(*fw), pe_cm, cd_pe, ref_t, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_primal_t, g_tang_t):
        pe_cm, cd_pe, *fw = ctx.saved_tensors
        g_primal_t = g_primal_t.float().contiguous()
        gfw = decode_bwd_kernel_v4s(FusedDecodeWeightsV6(*fw), pe_cm, cd_pe, g_primal_t,
                                    g_tang_t.float().contiguous(), ctx.compute_dtype)
        needs = ctx.needs_input_grad
        return (torch.zeros_like(pe_cm) if needs[0] else None,
                torch.zeros_like(cd_pe) if needs[1] else None,
                g_primal_t if needs[2] else None, None, *gfw)


def fused_decode_jvp_v4s_kbwd(fw: FusedDecodeWeightsV6, pe_cm: torch.Tensor, cd_pe: torch.Tensor,
                              ref_t: torch.Tensor,
                              compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FusedDecodeJvpV4s`` with the argument order of the JAX function."""
    return FusedDecodeJvpV4s.apply(pe_cm, cd_pe, ref_t, compute_dtype, *fw)


# ---------------------------------------------------------------------------
# v4 / v4t: the decode pair of the evaluation sweeps and of kernel_version=4.
# The tangent input is the compact dpe [3, N, in_ch/3] through the channel
# slices w1c of the layer-1 weights.  One kernel per pass serves both layouts.
# ---------------------------------------------------------------------------


def _point_shapes(n: int, n_vars: int, t_layout: bool):
    """Shapes of the per-point primal and tangent arrays in the given layout."""
    return ((n_vars, n), (3, n_vars, n)) if t_layout else ((n, n_vars), (3, n, n_vars))


def _jvp_v4(wrapper, fw: FusedDecodeWeights, pe, dpe, cd_pe, ref, compute_dtype, t_layout: bool,
            launcher: str = "dpn_decode_jvp_v4", plain=None):
    """A forward of the v4 family on the v4 inputs: ``plain`` (default
    ``decode_jvp_v4_ref`` in the given layout) on CPU tensors, ``launcher`` on CUDA ones."""
    name = wrapper.__name__
    if pe.device.type == "cpu":
        if plain is not None:
            return plain(fw, pe, dpe, cd_pe, ref, compute_dtype)
        return decode_jvp_v4_ref(fw, pe, dpe, cd_pe, ref, compute_dtype, t_layout=t_layout)
    if pe.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pe.device}")
    n_vars, (n, in_ch) = fw.w1.shape[0], pe.shape
    p_shape, t_shape = _point_shapes(n, n_vars, t_layout)
    lib, w = _jvp_kernel_inputs(name, SOURCE_JVP_V4, fw, dict(w1=fw.w1, w1c=fw.w1c), pe, cd_pe,
                                compute_dtype, [("dpe", dpe, (3, n, in_ch // 3), None),
                                                ("ref", ref, p_shape, torch.float32)])
    primal = torch.empty(p_shape, dtype=torch.float32, device=pe.device)
    tang = torch.empty(t_shape, dtype=torch.float32, device=pe.device)
    if n == 0:
        return primal, tang
    _launch(name, wrapper, getattr(lib, launcher), compute_dtype,
            [pe, dpe, cd_pe, ref, w["w1"], w["w1c"]] + [w[k] for k in _FWD_WEIGHTS] + [primal, tang],
            (n, in_ch, n_vars, int(t_layout)), pe.device)
    return primal, tang


def fused_decode_jvp_v4(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                        cd_pe: torch.Tensor, ref: torch.Tensor,
                        compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32): the CUDA kernel on GPU tensors.

    ``pe`` / ``cd_pe`` [N, in_ch] and ``dpe`` [3, N, in_ch//3] in
    ``compute_dtype``, ``ref`` [N, 6] float32.  CPU tensors take
    ``decode_jvp_v4_ref``; a CUDA tensor launches the kernel or raises.  The
    kernel's result carries no autograd graph: training goes through
    ``FusedDecodeJvpV4``.  ``fused_decode_jvp_v4.launches`` counts kernel launches."""
    return _jvp_v4(fused_decode_jvp_v4, fw, pe, dpe, cd_pe, ref, compute_dtype, False)


def fused_decode_jvp_v4t(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                         cd_pe: torch.Tensor, ref_t: torch.Tensor,
                         compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Var-major form of ``fused_decode_jvp_v4``: ``ref_t`` [6, N] -> primal [6, N]
    and tangents [3, 6, N], from the same kernel with the other layout flag.
    ``fused_decode_jvp_v4t.launches`` counts kernel launches."""
    return _jvp_v4(fused_decode_jvp_v4t, fw, pe, dpe, cd_pe, ref_t, compute_dtype, True)


fused_decode_jvp_v4.launches = 0
fused_decode_jvp_v4t.launches = 0


def _bwd_v4(wrapper, fw: FusedDecodeWeights, pe, dpe, cd_pe, g_primal, g_tang, compute_dtype,
            t_layout: bool) -> FusedDecodeWeights:
    name = wrapper.__name__
    if pe.device.type == "cpu":
        return decode_bwd_v4_ref(fw, pe, dpe, cd_pe, g_primal, g_tang, compute_dtype, t_layout)
    if pe.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pe.device}")
    n_vars, (n, in_ch) = fw.w1.shape[0], pe.shape
    p_shape, t_shape = _point_shapes(n, n_vars, t_layout)
    lib, w = _jvp_kernel_inputs(name, SOURCE_BWD_V4, fw, dict(w1=fw.w1, w1c=fw.w1c), pe, cd_pe,
                                compute_dtype, [("dpe", dpe, (3, n, in_ch // 3), None),
                                                ("g_primal", g_primal, p_shape, torch.float32),
                                                ("g_tang", g_tang, t_shape, torch.float32)])
    out = FusedDecodeWeights(*(
        g_primal.sum(1 if t_layout else 0) if k == "obias" else _zeros_f32(t)
        for k, t in zip(fw._fields, fw)))
    if n == 0:
        return out
    _launch(name, wrapper, lib.dpn_decode_bwd_v4, compute_dtype,
            [pe, dpe, cd_pe, g_primal, g_tang, w["w1"], w["w1c"]] + [w[k] for k in _BWD_WEIGHTS]
            + [out.w1, out.w1c] + [getattr(out, k) for k in _BWD_OUTPUTS],
            (n, in_ch, n_vars, int(t_layout)), pe.device)
    return out


def decode_bwd_kernel_v4(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                         cd_pe: torch.Tensor, g_primal: torch.Tensor, g_tang: torch.Tensor,
                         compute_dtype=torch.bfloat16) -> FusedDecodeWeights:
    """Weight cotangents of ``fused_decode_jvp_v4``: the CUDA kernel on GPU tensors.

    ``g_primal`` [N, 6] and ``g_tang`` [3, N, 6] float32.  ``w1`` and ``w1c``
    get separate cotangents; the ``obias`` slot carries ``sum_N g_primal``, a
    ``torch.sum`` outside the kernel.  CPU tensors take ``decode_bwd_v4_ref``; a
    CUDA tensor launches the kernel or raises.  The kernel sums across blocks
    with atomic adds, so its result is not bit-reproducible from run to run.
    ``decode_bwd_kernel_v4.launches`` counts kernel launches."""
    return _bwd_v4(decode_bwd_kernel_v4, fw, pe, dpe, cd_pe, g_primal, g_tang, compute_dtype, False)


def decode_bwd_kernel_v4t(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                          cd_pe: torch.Tensor, g_primal_t: torch.Tensor, g_tang_t: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> FusedDecodeWeights:
    """Var-major form of ``decode_bwd_kernel_v4``: cotangents [6, N] and [3, 6, N],
    into the same kernel with the other layout flag.
    ``decode_bwd_kernel_v4t.launches`` counts kernel launches."""
    return _bwd_v4(decode_bwd_kernel_v4t, fw, pe, dpe, cd_pe, g_primal_t, g_tang_t, compute_dtype,
                   True)


decode_bwd_kernel_v4.launches = 0
decode_bwd_kernel_v4t.launches = 0


class FusedDecodeJvpV4(torch.autograd.Function):
    """The v4 decode with a kernel on both passes, in either layout.

    ``FusedDecodeJvpV4.apply(pe, dpe, cd_pe, ref, compute_dtype, t_layout, *fw)``
    with ``fw`` a ``FusedDecodeWeights``.  The contract of
    ``fused_decode_jvp_v4_kbwd`` (:1678-1727) and ``fused_decode_jvp_v4t_kbwd``
    (:1736-1783): exact cotangents for the fused weights (``w1`` and ``w1c``
    separately), ``g_ref = g_primal``, and zeros for ``pe``, ``dpe`` and
    ``cd_pe``, which are functions of data only in the training engine.  Saved
    for backward: the fused weights and the three point inputs; no activations.
    First derivatives only."""

    @staticmethod
    def forward(ctx, pe, dpe, cd_pe, ref, compute_dtype, t_layout, *fw):
        ctx.compute_dtype, ctx.t_layout = compute_dtype, t_layout
        ctx.save_for_backward(pe, dpe, cd_pe, *fw)
        forward = fused_decode_jvp_v4t if t_layout else fused_decode_jvp_v4
        return forward(FusedDecodeWeights(*fw), pe, dpe, cd_pe, ref, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_primal, g_tang):
        pe, dpe, cd_pe, *fw = ctx.saved_tensors
        g_primal = g_primal.float().contiguous()
        backward = decode_bwd_kernel_v4t if ctx.t_layout else decode_bwd_kernel_v4
        gfw = backward(FusedDecodeWeights(*fw), pe, dpe, cd_pe, g_primal,
                       g_tang.float().contiguous(), ctx.compute_dtype)
        needs = ctx.needs_input_grad
        return (*(torch.zeros_like(x) if need else None
                  for x, need in zip((pe, dpe, cd_pe), needs)),
                g_primal if needs[3] else None, None, None, *gfw)


def fused_decode_jvp_v4_kbwd(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                             cd_pe: torch.Tensor, ref: torch.Tensor,
                             compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trainable ``fused_decode_jvp_v4`` ([N, 6] layout) with the JAX argument order."""
    return FusedDecodeJvpV4.apply(pe, dpe, cd_pe, ref, compute_dtype, False, *fw)


def fused_decode_jvp_v4t_kbwd(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                              cd_pe: torch.Tensor, ref_t: torch.Tensor,
                              compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trainable ``fused_decode_jvp_v4t`` ([6, N] layout) with the JAX argument order."""
    return FusedDecodeJvpV4.apply(pe, dpe, cd_pe, ref_t, compute_dtype, True, *fw)


# ---------------------------------------------------------------------------
# v6: the decode pair of kernel_version=6.  The algebra and the fused weights of
# v4s; the operand is the direction-major trig [3, N, 2F] and the results are
# point-major ([N, 6], [3, N, 6]).  Each pass shares its CUDA source with v4s.
# ---------------------------------------------------------------------------


def _v6_point_inputs(name: str, trig: torch.Tensor, cd_pe: torch.Tensor, compute_dtype):
    """The two point operands in the compute dtype, as the JAX wrappers cast them (:2060)."""
    if trig.ndim != 3 or trig.shape[0] != 3:
        raise ValueError(f"{name}: trig is {tuple(trig.shape)}, expected [3, N, 2F]")
    return trig.to(compute_dtype).contiguous(), cd_pe.to(compute_dtype).contiguous()


def fused_decode_jvp_v6(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                        ref: torch.Tensor,
                        compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32): the CUDA kernel on GPU tensors.

    ``trig`` [3, N, 2F] (``trig3_inputs``) and ``cd_pe`` [N, in_ch] are cast to
    ``compute_dtype``; ``ref`` [N, 6] float32.  CPU tensors take
    ``decode_jvp_v6_ref``; a CUDA tensor launches the kernel or raises.  The
    kernel's result carries no autograd graph: training goes through
    ``FusedDecodeJvpV6``.  ``fused_decode_jvp_v6.launches`` counts kernel launches."""
    name = "fused_decode_jvp_v6"
    trig, cd_pe = _v6_point_inputs(name, trig, cd_pe, compute_dtype)
    if trig.device.type == "cpu":
        return decode_jvp_v6_ref(fw, trig, cd_pe, ref, compute_dtype)
    if trig.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {trig.device}")
    n_vars, (n, in_ch) = fw.w1t.shape[0], cd_pe.shape
    lib, w = _jvp_kernel_inputs(name, SOURCE_JVP_V4S, fw, _v4s_matrices(fw), trig, cd_pe, compute_dtype,
                                [("ref", ref, (n, n_vars), torch.float32)],
                                pe_shape=(3, n, in_ch // 3))
    primal = torch.empty((n, n_vars), dtype=torch.float32, device=trig.device)
    tang = torch.empty((3, n, n_vars), dtype=torch.float32, device=trig.device)
    if n == 0:
        return primal, tang
    _launch(name, fused_decode_jvp_v6, lib.dpn_decode_jvp_v4s, compute_dtype,
            [trig, cd_pe, ref, w["w1g"], w["w1t"]] + [w[k] for k in _FWD_WEIGHTS] + [primal, tang],
            (n, in_ch, n_vars, 1), trig.device)
    return primal, tang


def decode_bwd_kernel_v6(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                         g_primal: torch.Tensor, g_tang: torch.Tensor,
                         compute_dtype=torch.bfloat16) -> FusedDecodeWeightsV6:
    """Weight cotangents of ``fused_decode_jvp_v6``: the CUDA kernel on GPU tensors.

    ``g_primal`` [N, 6] and ``g_tang`` [3, N, 6] float32.  The ``obias`` slot
    carries ``sum_N g_primal``, a ``torch.sum`` outside the kernel, as the caller
    of the TPU kernel forms it (:2277).  CPU tensors take ``decode_bwd_v6_ref``; a
    CUDA tensor launches the kernel or raises.  The kernel sums across blocks
    with atomic adds, so its result is not bit-reproducible from run to run.
    ``decode_bwd_kernel_v6.launches`` counts kernel launches."""
    name = "decode_bwd_kernel_v6"
    trig, cd_pe = _v6_point_inputs(name, trig, cd_pe, compute_dtype)
    if trig.device.type == "cpu":
        return decode_bwd_v6_ref(fw, trig, cd_pe, g_primal, g_tang, compute_dtype)
    if trig.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {trig.device}")
    n_vars, (n, in_ch) = fw.w1t.shape[0], cd_pe.shape
    lib, w = _jvp_kernel_inputs(name, SOURCE_BWD_V4S, fw, _v4s_matrices(fw), trig, cd_pe, compute_dtype,
                                [("g_primal", g_primal, (n, n_vars), torch.float32),
                                 ("g_tang", g_tang, (3, n, n_vars), torch.float32)],
                                pe_shape=(3, n, in_ch // 3))
    out = FusedDecodeWeightsV6(*(
        g_primal.sum(0) if k == "obias" else _zeros_f32(t) for k, t in zip(fw._fields, fw)))
    if n == 0:
        return out
    _launch(name, decode_bwd_kernel_v6, lib.dpn_decode_bwd_v4s, compute_dtype,
            [trig, cd_pe, g_primal, g_tang, w["w1g"], w["w1t"]] + [w[k] for k in _BWD_WEIGHTS]
            + [out.w1g, out.w1t] + [getattr(out, k) for k in _BWD_OUTPUTS],
            (n, in_ch, n_vars, 1), trig.device)
    return out


fused_decode_jvp_v6.launches = 0
decode_bwd_kernel_v6.launches = 0


class FusedDecodeJvpV6(torch.autograd.Function):
    """The v6 decode with a kernel on both passes.

    ``FusedDecodeJvpV6.apply(trig, cd_pe, ref, compute_dtype, *fw)`` with ``fw`` a
    ``FusedDecodeWeightsV6`` returns ``(primal [N, 6], tang [3, N, 6])``.  The
    contract of ``fused_decode_jvp_v6_kbwd`` (:2280-2321): exact cotangents for
    the ten fused weights, ``g_ref = g_primal``, ``g_obias = sum_N g_primal``, and
    zeros for ``trig`` and ``cd_pe``, which are functions of data only in the
    training engine.  Saved for backward: the fused weights, ``trig`` and
    ``cd_pe``; no activations (the backward kernel recomputes them).  In bf16 the
    backward kernel differentiates a forward whose tangents are not rounded
    before the ``fw2`` and ``w2wo`` sums, as the TPU pair does.  First
    derivatives only."""

    @staticmethod
    def forward(ctx, trig, cd_pe, ref, compute_dtype, *fw):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(trig, cd_pe, *fw)
        return fused_decode_jvp_v6(FusedDecodeWeightsV6(*fw), trig, cd_pe, ref, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_primal, g_tang):
        trig, cd_pe, *fw = ctx.saved_tensors
        g_primal = g_primal.float().contiguous()
        gfw = decode_bwd_kernel_v6(FusedDecodeWeightsV6(*fw), trig, cd_pe, g_primal,
                                   g_tang.float().contiguous(), ctx.compute_dtype)
        needs = ctx.needs_input_grad
        return (torch.zeros_like(trig) if needs[0] else None,
                torch.zeros_like(cd_pe) if needs[1] else None,
                g_primal if needs[2] else None, None, *gfw)


def fused_decode_jvp_v6_kbwd(fw: FusedDecodeWeightsV6, trig: torch.Tensor, cd_pe: torch.Tensor,
                             ref: torch.Tensor,
                             compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FusedDecodeJvpV6`` with the argument order of the JAX function."""
    return FusedDecodeJvpV6.apply(trig, cd_pe, ref, compute_dtype, *fw)


# ---------------------------------------------------------------------------
# v2 / v3: the round-1 decode without the collapse (DecodeWeights), forward only.
# v2 reads the interleaved PE and the compact tangent input dpe; v3 computes the
# channel-major PE inside the kernel from raw coordinates.  One CUDA source,
# csrc/decode_jvp_v2.cu, serves both.
# ---------------------------------------------------------------------------


def _v2_chain_ref(l1: _Layer1, w: DecodeWeights, cd_pe, wd, ref_t, cdt, round_wo: bool):
    """Var-major plain forward of the uncollapsed decode: ([V, N], [3, V, N]) float32.

    Line for line ``_decode_kernel`` (:166-236): every product's two operands are
    rounded to the compute dtype, ``c``, the tangents and the masked products stay
    float32 between products, and ``wo`` is rounded to the compute dtype with
    ``round_wo`` (the kernel's, :264) or read in float32 without it (the XLA twin
    ``decode_jvp_xla``'s, :1786-1824).  Differentiable."""
    z = dot_f32(l1.pe, l1.w1, cdt) + w.b1[:, None, :]  # [V, N, hid]
    mask = z > 0
    t = torch.stack([torch.where(mask, dot_f32(l1.tin[k], l1.w1k[:, k], cdt), 0.0)
                     for k in range(3)], dim=0)  # [3, V, N, hid]
    p2 = dot_f32(torch.relu(z), w.w2, cdt) + w.b2[:, None, :]
    t2 = dot_f32(t, w.w2[None], cdt)
    c = p2 + (dot_f32(cd_pe, wd, cdt) + w.bd[:, None, :]) + w.fh_add[:, None, :]
    r = dot_f32(c, w.f1, cdt) + w.g1[:, None, :]
    tr = torch.where((r > 0)[None], dot_f32(t2, w.f1[None], cdt), 0.0)
    y = dot_f32(torch.relu(r), w.f2, cdt) + w.g2[:, None, :] + 2.0 * c  # the trunk's skip
    ty = dot_f32(tr, w.f2[None], cdt) + 2.0 * t2
    wo = (w.wo.to(cdt) if round_wo else w.wo).float()
    o = (y * wo[:, None, :]).sum(-1) + w.bo[:, None] + ref_t  # [V, N]
    to = (ty * wo[None, :, None, :]).sum(-1)  # [3, V, N]
    return o, to


def decode_jvp_v2_ref(weights: DecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                      cd_pe: torch.Tensor, ref: torch.Tensor, compute_dtype=torch.bfloat16,
                      round_wo: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v2 kernel: ``([N, 6], [3, N, 6])`` float32.

    ``pe`` / ``cd_pe`` [N, in_ch], ``dpe`` [3, N, in_ch//3] (``pe_and_tangents``),
    ``ref`` [N, 6].  The tangent rows of layer 1 are ``slice_tangent_weights``.
    ``round_wo=True`` has the kernel's rounding, ``round_wo=False`` the XLA twin's
    (ROADMAP C19); the two agree exactly when the compute dtype is float32."""
    l1 = _Layer1(pe, weights.w1, (dpe[0], dpe[1], dpe[2]), slice_tangent_weights(weights.w1))
    o, to = _v2_chain_ref(l1, weights, cd_pe, weights.wd, ref.t(), compute_dtype, round_wo)
    return o.t(), to.transpose(1, 2)


_V2_MATRICES = ("w1", "w2", "wd", "f1", "f2", "wo")


def _v2_weights(w: DecodeWeights, cd, **tangent_rows) -> dict:
    """The decode weights as the v2 kernels read them, in launch order: ``w1``, the
    ``tangent_rows`` (v2's ``w1c``; none for v3), then the other fields.  The matrices and the
    head ``wo`` are in the compute dtype (the TPU wrappers cast ``wo`` too, :264, :447), the
    biases float32."""
    out = {"w1": w.w1.to(cd), **{k: t.to(cd) for k, t in tangent_rows.items()}}
    out.update({k: t.to(cd) if k in _V2_MATRICES else t.float() for k, t in zip(w._fields[1:], w[1:])})
    return {k: t.detach().contiguous() for k, t in out.items()}


def _v2_columns(w: DecodeWeights, cd) -> torch.Tensor:
    """z's and c's weights by column, [V, hid, 2 in_ch + hid] in ``cd``: row c of variable v holds
    the c-th columns of w1, w2 and wd, one after the other.  The bf16 v2 kernel sums its few values
    of z and c near a bf16 rounding tie again from them (``csrc/decode_jvp_v2.cu``), where a column
    of the row-major weight would take one 32-byte sector of memory a value."""
    return torch.cat([m.detach().to(cd).transpose(1, 2) for m in (w.w1, w.w2, w.wd)], dim=2).contiguous()


def fused_decode_jvp(weights: DecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                     cd_pe: torch.Tensor, ref: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32) of the v2 decode: the CUDA kernel on GPU
    tensors (``csrc/decode_jvp_v2.cu``).

    ``pe`` / ``cd_pe`` [N, in_ch] and ``dpe`` [3, N, in_ch//3] in ``compute_dtype``,
    ``ref`` [N, 6] float32.  CPU tensors take ``decode_jvp_v2_ref``; a CUDA tensor
    launches the kernel or raises.  The result carries no autograd graph: training
    goes through ``FusedDecodeJvpV2``.  ``fused_decode_jvp.launches`` counts kernel
    launches."""
    name = "fused_decode_jvp"
    if pe.device.type == "cpu":
        return decode_jvp_v2_ref(weights, pe, dpe, cd_pe, ref, compute_dtype)
    if pe.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pe.device}")
    n_vars, in_ch, hid = weights.w1.shape
    n = pe.shape[0]
    w = _v2_weights(weights, compute_dtype, w1c=slice_tangent_weights(weights.w1))
    w["cols"] = _v2_columns(weights, compute_dtype)
    lib = _kernel_checks(name, SOURCE_JVP_V2, hid, in_ch, compute_dtype,
                         [("pe", pe, (n, in_ch), None), ("dpe", dpe, (3, n, in_ch // 3), None),
                          ("cd_pe", cd_pe, (n, in_ch), None), ("ref", ref, (n, n_vars), torch.float32)],
                         w.values())
    primal = torch.empty((n, n_vars), dtype=torch.float32, device=pe.device)
    tang = torch.empty((3, n, n_vars), dtype=torch.float32, device=pe.device)
    if n == 0:
        return primal, tang
    _launch(name, fused_decode_jvp, lib.dpn_decode_jvp_v2, compute_dtype,
            [pe, dpe, cd_pe, ref, *w.values(), primal, tang], (n, in_ch, n_vars, 0), pe.device)
    return primal, tang


fused_decode_jvp.launches = 0


class FusedDecodeJvpV2(torch.autograd.Function):
    """The v2 decode with the kernel on the forward pass: ``fused_decode_jvp_trainable``
    (:1827-1862).

    ``FusedDecodeJvpV2.apply(pe, dpe, cd_pe, ref, compute_dtype, *weights)`` with
    ``weights`` a ``DecodeWeights`` returns ``(primal [N, 6], tang [3, N, 6])``.  The TPU
    has no backward kernel for v2, and neither has the port: the backward recomputes the
    plain version with the XLA twin's rounding (``round_wo=False``) under autograd and
    returns its vector-Jacobian product for every input, as JAX's custom VJP does.  Saved
    for backward: the inputs; no activations.  First derivatives only."""

    @staticmethod
    def forward(ctx, pe, dpe, cd_pe, ref, compute_dtype, *weights):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(pe, dpe, cd_pe, ref, *weights)
        return fused_decode_jvp(DecodeWeights(*weights), pe, dpe, cd_pe, ref, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_primal, g_tang):
        needs = ctx.needs_input_grad[:4] + ctx.needs_input_grad[5:]
        inputs = [x.detach().requires_grad_(need) for x, need in zip(ctx.saved_tensors, needs)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            pe, dpe, cd_pe, ref, *weights = inputs
            outs = decode_jvp_v2_ref(DecodeWeights(*weights), pe, dpe, cd_pe, ref, ctx.compute_dtype,
                                     round_wo=False)
            grads = iter(torch.autograd.grad(outs, wanted, (g_primal, g_tang), allow_unused=True))
        out = [next(grads) if x.requires_grad else None for x in inputs]
        return (*out[:4], None, *out[4:])


def fused_decode_jvp_trainable(weights: DecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                               cd_pe: torch.Tensor, ref: torch.Tensor,
                               compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FusedDecodeJvpV2`` with the argument order of the JAX function."""
    return FusedDecodeJvpV2.apply(pe, dpe, cd_pe, ref, compute_dtype, *weights)


# ---- the in-kernel PE front end of v3 and v4pe ----------------------------------------


def _check_pe_front_end(name: str, n_vars: int, in_ch: int, coord_spec) -> None:
    """The front end builds 3 coordinate blocks of 2F lanes and, from the 6 conditioning values
    (also the 6 variables' reference values), 6 blocks of 2F / 2 lanes: in_ch must be
    6 * ``coord_spec.n_freqs`` (JAX's v4pe check, :1337-1340) and the variables 6."""
    n_freqs = in_ch // 6
    if in_ch % 12 or n_freqs != coord_spec.n_freqs:
        raise ValueError(f"{name}: decode in_channels {in_ch} implies {n_freqs} coordinate frequencies "
                         f"but coord_spec.n_freqs={coord_spec.n_freqs}")
    if n_vars != 6:
        raise ValueError(f"{name}: the 6 conditioning values are the variables' reference values; "
                         f"got {n_vars} variables")


def _perm(in_ch: int, n_channels: int, device) -> torch.Tensor:
    return torch.as_tensor(channel_major_perm(in_ch, n_channels), device=device)


def pe_front_end(coords: torch.Tensor, coord_data: torch.Tensor, coord_spec,
                 in_ch: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the in-kernel PE of v3 and v4pe (``_decode_kernel_v3``, :339-360;
    ``_decode_kernel_v4pe``, :1264-1284), float32:
    ``(pe_cm [N, in_ch], tangents [3, N, in_ch/3], cd_cm [N, in_ch])``.

    Block c of ``pe_cm`` is ``[sin(fb cn_c) | cos(fb cn_c)]`` with ``cn = coords * scales``;
    direction k's tangent is ``[(cos(fb cn_k) fb) s_k | (-sin(fb cn_k) fb) s_k]`` with ``s_k``
    the k-th scale; block c of ``cd_cm`` is ``[sin(fb2 x_c) | cos(fb2 x_c)]`` of conditioning
    value c with ``fb2 = make_freq_bands(in_ch / 12, 4.0)``.  These are ``pe_and_tangents``
    and the cd PE with their features in channel-major order (``channel_major_perm``): the
    same angles, rounded the same way."""
    pe, dpe = pe_and_tangents(coords, coord_spec)
    cd = sinecos_pe(coord_data, make_freq_bands(in_ch // 12, max_freq=4.0))
    dev = coords.device
    return (pe[:, _perm(in_ch, 3, dev)], dpe[:, :, _perm(in_ch // 3, 1, dev)],
            cd[:, _perm(in_ch, 6, dev)])


def _pe_point_rows(coords: torch.Tensor, coord_data: torch.Tensor, coord_spec, in_ch: int):
    """The in-kernel PE's inputs, as (name, tensor, shape, dtype) rows in launch order: raw
    coordinates [N, 3], conditioning values [N, 6] (also the reference values), the scales
    [3] and the two sets of frequency bands, all float32 on the coordinates' device."""
    f32, dev, n = torch.float32, coords.device, coords.shape[0]
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=f32, device=dev)
    fb2 = torch.as_tensor(make_freq_bands(in_ch // 12, max_freq=4.0), dtype=f32, device=dev)
    return [("coords", coords.float().contiguous(), (n, 3), f32),
            ("coord_data", coord_data.float().contiguous(), (n, 6), f32),
            ("scales", coord_scales(coord_spec, dev), (3,), f32),
            ("fb", fb, (in_ch // 6,), f32), ("fb2", fb2, (in_ch // 12,), f32)]


def decode_jvp_v3_ref(weights: DecodeWeights, coords: torch.Tensor, coord_data: torch.Tensor,
                      coord_spec, compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v3 kernel (``_decode_kernel_v3``, :315-400):
    ``([N, 6], [3, N, 6])`` float32.

    The v2 chain (with the kernel's rounding of ``wo``) behind ``pe_front_end``: ``w1`` and
    ``wd`` channel-major, direction k's tangent rows the contiguous rows ``k*2F:(k+1)*2F``
    of ``w1``, the conditioning values ``coord_data`` [N, 6] also the reference values."""
    n_vars, in_ch, hid = weights.w1.shape
    _check_pe_front_end("fused_decode_jvp_v3", n_vars, in_ch, coord_spec)
    pe_cm, t_cm, cd_cm = pe_front_end(coords, coord_data, coord_spec, in_ch)
    w1 = weights.w1[:, _perm(in_ch, 3, coords.device)]
    l1 = _Layer1(pe_cm, w1, (t_cm[0], t_cm[1], t_cm[2]), w1.reshape(n_vars, 3, in_ch // 3, hid))
    o, to = _v2_chain_ref(l1, weights, cd_cm, weights.wd[:, _perm(in_ch, 6, coords.device)],
                          coord_data.float().t(), compute_dtype, round_wo=True)
    return o.t(), to.transpose(1, 2)


def fused_decode_jvp_v3(weights: DecodeWeights, coords: torch.Tensor, coord_data: torch.Tensor,
                        coord_spec, compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32) of the v2 decode with the PE computed in
    the kernel: raw coordinates [N, 3] (physical x, y, t) and conditioning values [N, 6] in.
    The CUDA kernel on GPU tensors (``csrc/decode_jvp_v2.cu`` with the PE front end of
    ``csrc/decode_pe.cuh``); CPU tensors take ``decode_jvp_v3_ref``.
    ``fused_decode_jvp_v3.launches`` counts kernel launches."""
    name = "fused_decode_jvp_v3"
    n_vars, in_ch, hid = weights.w1.shape
    _check_pe_front_end(name, n_vars, in_ch, coord_spec)
    if coords.device.type == "cpu":
        return decode_jvp_v3_ref(weights, coords, coord_data, coord_spec, compute_dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {coords.device}")
    dev, n = coords.device, coords.shape[0]
    w = _v2_weights(weights._replace(w1=weights.w1[:, _perm(in_ch, 3, dev)],
                                     wd=weights.wd[:, _perm(in_ch, 6, dev)]), compute_dtype)
    rows = _pe_point_rows(coords, coord_data, coord_spec, in_ch)
    lib = _kernel_checks(name, SOURCE_JVP_V2, hid, in_ch, compute_dtype, rows, w.values())
    primal = torch.empty((n, n_vars), dtype=torch.float32, device=dev)
    tang = torch.empty((3, n, n_vars), dtype=torch.float32, device=dev)
    if n == 0:
        return primal, tang
    _launch(name, fused_decode_jvp_v3, lib.dpn_decode_jvp_v3, compute_dtype,
            [r[1] for r in rows] + [*w.values(), primal, tang], (n, in_ch, n_vars, 0), dev)
    return primal, tang


fused_decode_jvp_v3.launches = 0


# ---------------------------------------------------------------------------
# v4pe / v5: the collapsed v4 algebra with the PE computed in the kernel (v4pe,
# the in_kernel_pe route of fused_kernel_fields) and with r summed in another
# order (v5).  Both are compile-time variants of csrc/decode_jvp_v4.cu.
# ---------------------------------------------------------------------------


def _channel_major(fw: FusedDecodeWeights) -> FusedDecodeWeights:
    """``w1``, ``wdf1`` and ``wdwo`` with their input rows in the front end's channel-major
    order (the v4pe wrapper's gathers, :1348-1353)."""
    in_ch, dev = fw.w1.shape[1], fw.w1.device
    perm, perm_cd = _perm(in_ch, 3, dev), _perm(in_ch, 6, dev)
    return fw._replace(w1=fw.w1[:, perm], wdf1=fw.wdf1[:, perm_cd], wdwo=fw.wdwo[:, perm_cd])


def decode_jvp_v4pe_ref(fw: FusedDecodeWeights, coords: torch.Tensor, coord_data: torch.Tensor,
                        coord_spec, compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v4pe kernel (``_decode_kernel_v4pe``, :1249-1291):
    ``([N, 6], [3, N, 6])`` float32.

    ``pe_front_end`` with its three outputs rounded to the compute dtype (``P_in``, the
    tangent blocks and ``CD``, :1270, :1276, :1280), then the v4 chain with the kernel's
    rounding on the channel-major weights; ``coord_data`` is the reference value."""
    n_vars, in_ch, hid = fw.w1.shape
    _check_pe_front_end("fused_decode_jvp_v4pe", n_vars, in_ch, coord_spec)
    cdt = compute_dtype
    pe_cm, t_cm, cd_cm = (x.to(cdt) for x in pe_front_end(coords, coord_data, coord_spec, in_ch))
    fw = _channel_major(fw)
    l1 = _Layer1(pe_cm, fw.w1, (t_cm[0], t_cm[1], t_cm[2]), fw.w1.reshape(n_vars, 3, in_ch // 3, hid))
    o, to = _jvp_ref(l1, fw, cd_cm, coord_data.float().t(), cdt, round_tangents=True)
    return o.t(), to.transpose(1, 2)


def fused_decode_jvp_v4pe(fw: FusedDecodeWeights, coords: torch.Tensor, coord_data: torch.Tensor,
                          coord_spec, compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32) of the v4 decode with the PE computed in
    the kernel: raw coordinates [N, 3] and conditioning values [N, 6] in.  The CUDA kernel on
    GPU tensors (``csrc/decode_jvp_v4.cu``, in-kernel PE variant); CPU tensors take
    ``decode_jvp_v4pe_ref``.  Forward only.  ``fused_decode_jvp_v4pe.launches`` counts
    kernel launches."""
    name = "fused_decode_jvp_v4pe"
    n_vars, in_ch, hid = fw.w1.shape
    _check_pe_front_end(name, n_vars, in_ch, coord_spec)
    if coords.device.type == "cpu":
        return decode_jvp_v4pe_ref(fw, coords, coord_data, coord_spec, compute_dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {coords.device}")
    dev, n = coords.device, coords.shape[0]
    fw = _channel_major(fw)
    w = _fused_weights(fw, dict(w1=fw.w1), compute_dtype)
    rows = _pe_point_rows(coords, coord_data, coord_spec, in_ch)
    lib = _kernel_checks(name, SOURCE_JVP_V4, hid, in_ch, compute_dtype, rows, w.values())
    primal = torch.empty((n, n_vars), dtype=torch.float32, device=dev)
    tang = torch.empty((3, n, n_vars), dtype=torch.float32, device=dev)
    if n == 0:
        return primal, tang
    _launch(name, fused_decode_jvp_v4pe, lib.dpn_decode_jvp_v4pe, compute_dtype,
            [r[1] for r in rows] + [*w.values(), primal, tang], (n, in_ch, n_vars, 0), dev)
    return primal, tang


fused_decode_jvp_v4pe.launches = 0


def decode_jvp_v5_ref(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                      cd_pe: torch.Tensor, ref: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v5 kernel (``_decode_kernel_v5``, :1117-1172):
    ``([N, 6], [3, N, 6])`` float32 from the v4 inputs.  The v4 function with the kernel's
    rounding, ``r`` summed as ``p . w2f1 + (cd . wdf1 + rbias)``.  The TPU kernel stacks the
    six variables' layer-1 weights by column into one wide product, which changes no sum."""
    o, to = _jvp_ref(_layer1_v4(fw, pe, dpe), fw, cd_pe, ref.t(), compute_dtype, True, split_rbias=True)
    return o.t(), to.transpose(1, 2)


def fused_decode_jvp_v5(fw: FusedDecodeWeights, pe: torch.Tensor, dpe: torch.Tensor,
                        cd_pe: torch.Tensor, ref: torch.Tensor,
                        compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primal [N, 6] and tangents [3, N, 6] (float32) of v5: the CUDA kernel on GPU tensors
    (``csrc/decode_jvp_v4.cu``, the variant that keeps ``cd . wdf1 + rbias`` in an accumulator
    of its own).  Inputs as ``fused_decode_jvp_v4``; CPU tensors take ``decode_jvp_v5_ref``.
    ``fused_decode_jvp_v5.launches`` counts kernel launches."""
    return _jvp_v4(fused_decode_jvp_v5, fw, pe, dpe, cd_pe, ref, compute_dtype, False,
                   launcher="dpn_decode_jvp_v5", plain=decode_jvp_v5_ref)


fused_decode_jvp_v5.launches = 0
