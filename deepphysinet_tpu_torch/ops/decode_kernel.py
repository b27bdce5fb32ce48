"""Collapsed primal decode: per-window weight fusion and the Hopper kernel.

Counterpart of the inference parts of ``deepphysinet_tpu/ops/decode_kernel.py``:

* ``DecodeWeights`` / ``extract_decode_weights`` (:59-115): the effective
  decode weights of one window, generated from the encoder tokens (float32
  einsums, unlike VariableNet's compute-dtype dense layers);
* ``FusedDecodeWeights`` / ``fuse_decode_weights`` (:480-525): the collapsed
  v4 algebra, which folds the trunk's second layer and the scalar head into
  per-window matrices (the tangent rows ``w1c`` belong to the jvp kernels and
  are not ported yet);
* ``pe_primal``: the primal half of ``pe_and_tangents`` (:118-155);
* ``decode_primal_v4t``: the var-major primal decode, backed by the CUDA
  kernel ``csrc/decode_primal.cu`` on GPU tensors and by its plain version
  ``decode_primal_v4t_ref`` (a mirror of ``decode_xla_v4t_primal``,
  :1053-1082) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.ops.precision import dot_f32

SOURCE = "decode_primal.cu"


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
    b1: torch.Tensor  # [6, hid]
    w2f1: torch.Tensor  # [6, hid, hid] = w2 @ f1
    wdf1: torch.Tensor  # [6, in_ch, hid] = wd @ f1
    rbias: torch.Tensor  # [6, hid] = (b2 + bd + fh_add) @ f1 + g1
    fw2: torch.Tensor  # [6, hid] = f2 @ wo
    w2wo: torch.Tensor  # [6, hid] = w2 @ wo
    wdwo: torch.Tensor  # [6, in_ch] = wd @ wo
    obias: torch.Tensor  # [6] = g2.wo + 2 (b2 + bd + fh_add).wo + bo


def fuse_decode_weights(w: DecodeWeights) -> FusedDecodeWeights:
    """Per-window float32 weight fusion for the collapsed decode."""
    cbias = w.b2 + w.bd + w.fh_add  # [6, hid] constant part of c
    return FusedDecodeWeights(
        w1=w.w1,
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


def pe_primal(coords: torch.Tensor, coord_spec, dtype=torch.float32) -> torch.Tensor:
    """SineCos PE of physical (x, y, t) [N, 3] -> [N, 2F*3] in ``dtype``.

    The primal half of the JAX ``pe_and_tangents``: it normalizes with the
    product ``coords * scales`` (not ``encode_coord``'s divisions), so the
    angles round the same way as on the JAX decode path."""
    scales = torch.tensor(
        [1.0 / (coord_spec.dx * (coord_spec.lon_size - 1)),
         1.0 / (coord_spec.dy * (coord_spec.lat_size - 1)),
         1.0 / coord_spec.pred_t_span], dtype=torch.float32, device=coords.device)
    cn = coords.float() * scales  # [N, 3] normalized
    fb = torch.as_tensor(coord_spec.freq_bands(), dtype=torch.float32, device=coords.device)
    xf = (cn[..., :, None] * fb).transpose(-1, -2)  # [N, F, 3]
    pe = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(cn.shape[0], -1)
    return pe.to(dtype)


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
    for fn in (lib.dpn_decode_primal_hid, lib.dpn_decode_primal_k_tile, lib.dpn_decode_primal_block):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


# The kernel's shared memory: p [64, hid] f32, one weight tile [32, hid] and
# the block's pe / cd rows; a Hopper block may use 232,448 bytes.
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
    elt = torch.finfo(compute_dtype).bits // 8
    smem = lib.dpn_decode_primal_block() * (4 * hid + 2 * elt * in_ch) + \
        lib.dpn_decode_primal_k_tile() * hid * elt
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
