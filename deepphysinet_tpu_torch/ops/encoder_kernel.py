"""The whole variable encoder in one kernel launch, forward only.

Counterpart of ``deepphysinet_tpu/ops/encoder_kernel.py``.  As separate PyTorch
operators the flagship encoder (4 post-norm layers over 287 tokens x 256 dims) is
about fifty small launches; ``fused_encoder_forward`` runs the layers, the final
LayerNorm and the projection in one launch of ``csrc/encoder.cu`` on a CUDA tensor
(or raises) and its plain version ``fused_encoder_forward_ref`` on a CPU tensor;
``fused_encoder_forward.launches`` counts kernel launches.  In bf16 the kernel runs its
products on the tensor cores in clusters of four blocks (``kernel_route`` says which body
a shape takes); float32 keeps the CUDA-core body.

* ``extract_encoder_weights``: the port's encoder modules stacked per layer and
  sliced per head, in the shapes of the JAX function (:76-118);
* ``fused_encoder_forward_ref``: the TPU kernel's op chain (:132-190) with its
  rounding points -- per-head q/k/v dense layers rounded to the compute dtype
  before their bias, float32 scores and softmax, ``a . v`` in the compute dtype,
  the out-projection summed over heads in float32 and rounded once, LayerNorm in
  float32 (eps 1e-6) after each residual, a tanh-gelu or relu FFN, the final norm
  and the projection, returned as float32;
* ``encode_fused``: a forward-only drop-in for ``PhysicsNet.encode``; the
  embedding runs as PyTorch operators, then one launch per batch item (:233-260).
  Nothing in the port calls it: as in the JAX package, it is a public function
  for forward-only paths.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepphysinet_tpu_torch.models.transformer_net import LAYER_NORM_EPS
from deepphysinet_tpu_torch.ops.decode_kernel import _MAX_SHARED_BYTES
from deepphysinet_tpu_torch.ops.precision import dot_f32

SOURCE = "encoder.cu"


class EncoderKernelWeights(NamedTuple):
    """Per-layer-stacked, per-head-sliced encoder weights."""

    wq: torch.Tensor  # [NL, H, D, E]
    bq: torch.Tensor  # [NL, H, E]
    wk: torch.Tensor  # [NL, H, D, E]
    bk: torch.Tensor  # [NL, H, E]
    wv: torch.Tensor  # [NL, H, D, E]
    bv: torch.Tensor  # [NL, H, E]
    wo: torch.Tensor  # [NL, H, E, D]
    bo: torch.Tensor  # [NL, D]
    ln1s: torch.Tensor  # [NL, D]
    ln1b: torch.Tensor  # [NL, D]
    w1: torch.Tensor  # [NL, D, F]
    b1: torch.Tensor  # [NL, F]
    w2: torch.Tensor  # [NL, F, D]
    b2: torch.Tensor  # [NL, D]
    ln2s: torch.Tensor  # [NL, D]
    ln2b: torch.Tensor  # [NL, D]
    lns: torch.Tensor  # [D] final norm
    lnb: torch.Tensor  # [D]
    wproj: torch.Tensor  # [D, C]
    bproj: torch.Tensor  # [C]


# the matrices, which the kernel reads in the compute dtype; everything else is float32
_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2", "wproj")


@torch.no_grad()
def extract_encoder_weights(model) -> EncoderKernelWeights:
    """Stack and head-slice the encoder of a port ``PhysicsNet`` (float32)."""
    net = model.meta_net.model
    layers = net.encoder.attn_layers
    h = layers[0].attention.n_heads
    d = net.projection.kernel().shape[0]
    e = d // h

    def head_cols(dense):
        return (dense.kernel().reshape(d, h, e).permute(1, 0, 2),  # [H, D, E]
                dense.bias.reshape(h, e))

    cols = {k: [] for k in EncoderKernelWeights._fields[:16]}  # the per-layer fields
    for layer in layers:
        att = layer.attention
        for name, dense in (("q", att.query_projection), ("k", att.key_projection), ("v", att.value_projection)):
            w, b = head_cols(dense)
            cols["w" + name].append(w)
            cols["b" + name].append(b)
        # the out-projection consumes the heads side by side: rows h E .. (h + 1) E are head h's
        cols["wo"].append(att.out_projection.kernel().reshape(h, e, d))
        cols["bo"].append(att.out_projection.bias)
        cols["w1"].append(layer.conv1.kernel())
        cols["b1"].append(layer.conv1.bias)
        cols["w2"].append(layer.conv2.kernel())
        cols["b2"].append(layer.conv2.bias)
        for n in ("1", "2"):
            norm = getattr(layer, "norm" + n)
            cols[f"ln{n}s"].append(norm.weight)
            cols[f"ln{n}b"].append(norm.bias)
    cols.update(lns=net.encoder.norm.weight, lnb=net.encoder.norm.bias, wproj=net.projection.kernel(),
                bproj=net.projection.bias)
    return EncoderKernelWeights(**{k: (torch.stack(v) if isinstance(v, list) else v).detach().float().contiguous()
                                   for k, v in cols.items()})


def cast_encoder_weights(w: EncoderKernelWeights, compute_dtype) -> EncoderKernelWeights:
    """The matrices in ``compute_dtype``, the rest in float32, all contiguous: what the
    kernel reads (a no-op on weights already cast)."""
    return EncoderKernelWeights(*(
        getattr(w, k).to(compute_dtype if k in _MATRICES else torch.float32).contiguous()
        for k in EncoderKernelWeights._fields))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm`` as the TPU kernel writes it: float32, eps 1e-6."""
    mean = x.mean(-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(-1, keepdim=True)
    return c * torch.rsqrt(var + LAYER_NORM_EPS) * scale.float() + bias.float()


def _activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    return F.relu(x) if activation == "relu" else F.gelu(x, approximate="tanh")


@torch.no_grad()
def fused_encoder_forward_ref(w: EncoderKernelWeights, x: torch.Tensor, activation: str = "gelu",
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the encoder kernel: tokens [L, D] float32 -> [L, C] float32."""
    cdt = compute_dtype

    def dot(a, b):
        return dot_f32(a, b, cdt)

    def dense(a, wm, bias):
        return dot(a, wm).to(cdt) + bias.to(cdt)

    n_layers, n_heads, _, e = w.wq.shape
    scale = 1.0 / (e ** 0.5)
    x = x.float()
    for lay in range(n_layers):
        attn = torch.zeros_like(x)
        for hd in range(n_heads):
            qh = dense(x, w.wq[lay, hd], w.bq[lay, hd])
            kh = dense(x, w.wk[lay, hd], w.bk[lay, hd])
            vh = dense(x, w.wv[lay, hd], w.bv[lay, hd])
            s = dot(qh, kh.t()) * scale
            ex = torch.exp(s - s.amax(-1, keepdim=True))
            a = ex / ex.sum(-1, keepdim=True)
            oh = dot(a, vh).to(cdt)
            attn = attn + dot(oh, w.wo[lay, hd])
        new_x = attn.to(cdt) + w.bo[lay].to(cdt)
        x = _layer_norm(x + new_x.float(), w.ln1s[lay], w.ln1b[lay])
        y = _activation(dense(x, w.w1[lay], w.b1[lay]).float(), activation).to(cdt)
        y = dense(y, w.w2[lay], w.b2[lay])
        x = _layer_norm(x + y.float(), w.ln2s[lay], w.ln2b[lay])
    x = _layer_norm(x, w.lns, w.lnb)
    return dense(x, w.wproj, w.bproj).float()


# The bf16 kernel's weight tiles (csrc/encoder.cu, namespace tce): each product's output columns
# are split over the CLUSTER blocks of a cluster by n8 tiles, and a block's slice is one tile
# [up16(K), ld] (ld = the slice's width rounded up to 16, plus 8) with zeros past K and past the
# slice, so that one bulk copy fills a shared-memory slot in the layout the tensor cores read
# (widths up to 256: a tile of at most [256, 72]).  ``pack_encoder_weights`` lays the tiles out.
CLUSTER, SLOT_BYTES = 4, 256 * 72 * 2
_PACKED = ("wo", "w1", "w2", "wq", "wk", "wv")  # a layer's products, in the kernel's order; then wproj


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def tile_geometry(k: int, n: int, rank: int):
    """(c0, nc, ld, rows) of block ``rank``'s tile of a [k, n] product (``tce::Weight``)."""
    nt = n // 8
    c0, nc = 8 * (rank * nt // CLUSTER), 8 * ((rank + 1) * nt // CLUSTER - rank * nt // CLUSTER)
    return c0, nc, _up16(nc) + 8, _up16(k)


def _product_shapes(n_layers, n_heads, d, e, f, c):
    """(matrix field, layer, K, N) of every product, in the order of the packed array."""
    he = n_heads * e
    kn = {"wo": (he, d), "w1": (d, f), "w2": (f, d), "wq": (d, he), "wk": (d, he), "wv": (d, he)}
    return [(m, lay, *kn[m]) for lay in range(n_layers) for m in _PACKED] + [("wproj", -1, d, c)]


@functools.lru_cache(maxsize=8)
def _pack_plan(n_layers: int, n_heads: int, d: int, e: int, f: int, c: int):
    """(index, offsets) on the CPU: packed element i is element index[i] of the weights' matrices
    flattened in ``_PACKED`` + ``wproj`` order, the last one past them a zero; offsets[p, rank] is
    where block rank's tile of product p starts."""
    he = n_heads * e
    size = {"wo": n_layers * he * d, "w1": n_layers * d * f, "w2": n_layers * f * d, "wq": n_layers * d * he,
            "wk": n_layers * d * he, "wv": n_layers * d * he, "wproj": d * c}
    base, at = {}, 0
    for m in _PACKED + ("wproj",):
        base[m], at = at, at + size[m]
    zero = at
    parts, offsets, at = [], [], 0
    for m, lay, k, n in _product_shapes(n_layers, n_heads, d, e, f, c):
        row = []
        for rank in range(CLUSTER):
            c0, nc, ld, rows = tile_geometry(k, n, rank)
            kk = torch.arange(rows).view(-1, 1)
            col = c0 + torch.arange(ld).view(1, -1)
            if m in ("wq", "wk", "wv"):  # [NL, H, D, E]: column h E + e' of row k
                src = base[m] + lay * he * d + (col // e) * d * e + kk * e + col % e
            elif m == "wproj":
                src = base[m] + kk * n + col
            else:  # [NL, K, N]
                src = base[m] + lay * k * n + kk * n + col
            idx = torch.where((kk < k) & (col < c0 + nc), src, torch.full_like(src, zero))
            parts.append(idx.reshape(-1))
            row.append(at)
            at += idx.numel()
        offsets.append(row)
    return torch.cat(parts).to(torch.int32 if zero < 2 ** 31 else torch.int64), torch.tensor(offsets, dtype=torch.int64)


@functools.lru_cache(maxsize=8)
def _pack_plan_on(n_layers, n_heads, d, e, f, c, device: str):
    index, offsets = _pack_plan(n_layers, n_heads, d, e, f, c)
    return index.to(device), offsets.to(device)


def pack_encoder_weights(w: EncoderKernelWeights):
    """(packed, offsets): the matrices of ``w`` (in their own dtype, on their device) as the bf16
    kernel's tiles, and where each block's tile of each product starts (``tile_geometry``)."""
    n_layers, n_heads, d, e = w.wq.shape
    f, c = w.w1.shape[-1], w.wproj.shape[-1]
    index, offsets = _pack_plan_on(n_layers, n_heads, d, e, f, c, str(w.wq.device))
    src = torch.cat([getattr(w, m).reshape(-1) for m in _PACKED + ("wproj",)] + [w.wq.new_zeros(1)])
    return src.index_select(0, index), offsets


class _EncoderArgs(ctypes.Structure):
    """``dpn::EncoderArgs`` of ``csrc/encoder.cu``."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("x",) + EncoderKernelWeights._fields + ("xres", "qkv", "o", "out")]
                + [(k, ctypes.c_int) for k in ("L", "D", "H", "E", "F", "C", "NL", "gelu")]
                + [("scale", ctypes.c_float), ("packed", ctypes.c_void_p), ("offsets", ctypes.c_void_p)])


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library; declare its C signatures."""
    from deepphysinet_tpu_torch.ops.cuda_build import load_library

    return declare(load_library(SOURCE))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from ``csrc/encoder.cu``."""
    lib.dpn_encoder.argtypes = [ctypes.c_int, ctypes.POINTER(_EncoderArgs), ctypes.c_void_p]
    lib.dpn_encoder.restype = ctypes.c_int
    lib.dpn_encoder_shared_bytes.argtypes = [ctypes.c_int] * 7
    lib.dpn_encoder_shared_bytes.restype = ctypes.c_longlong
    lib.dpn_encoder_route.argtypes = [ctypes.c_int] * 7
    lib.dpn_encoder_route.restype = ctypes.c_int
    return lib


def kernel_route(w: EncoderKernelWeights, length: int, compute_dtype=torch.bfloat16) -> int:
    """The body the kernel takes for ``length`` tokens on these weights' shapes (on the current
    card): the tensor-core body's padded head width (16, 32 or 64; bf16 with heads up to 64 wide,
    products up to 1,024 columns), or 0 for the CUDA-core body (float32, and bf16 past those)."""
    n_heads, d, e = w.wq.shape[1:]
    return _library().dpn_encoder_route(int(compute_dtype == torch.bfloat16), length, d, n_heads, e,
                                        w.w1.shape[-1], w.wproj.shape[-1])


def fused_encoder_forward(w: EncoderKernelWeights, x: torch.Tensor, activation: str = "gelu",
                          compute_dtype=torch.bfloat16, packed=None) -> torch.Tensor:
    """Tokens [L, D] (float32, after the embedding) -> encoder output [L, C] float32.

    CPU tensors take ``fused_encoder_forward_ref``; a CUDA tensor launches the kernel
    (one launch) or raises.  ``fused_encoder_forward.launches`` counts kernel launches.
    ``packed``: ``pack_encoder_weights`` of the cast weights, for calls that share them (made
    here when the tensor-core body needs it and none is given)."""
    if x.device.type == "cpu":
        return fused_encoder_forward_ref(w, x, activation, compute_dtype)
    name = "fused_encoder_forward"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} not supported")
    if activation not in ("gelu", "relu"):
        raise ValueError(f"{name}: activation {activation!r} not supported")
    w = cast_encoder_weights(w, compute_dtype)
    n_layers, n_heads, d, e = w.wq.shape
    length, f, c = x.shape[0], w.w1.shape[-1], w.wproj.shape[-1]
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"{name}: tokens {tuple(x.shape)}, expected [L, {d}]")
    for t in w:
        if t.device != x.device:
            raise ValueError(f"{name}: weights on {t.device}, tokens on {x.device}")
    if any(n % 8 for n in (d, e, f, c)):
        raise ValueError(f"{name}: widths d_model {d}, head {e}, d_ff {f}, c_out {c} must be multiples "
                         "of 8 (16-byte loads)")
    lib = _library()
    smem = lib.dpn_encoder_shared_bytes(int(compute_dtype == torch.bfloat16), length, d, n_heads, e, f, c)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: {length} tokens of {n_heads} heads x {e} need {smem} bytes of "
                         f"shared memory, more than a block's {_MAX_SHARED_BYTES}")
    # 16-byte loads: a view that starts off a 16-byte boundary is copied
    x = x.float().contiguous()
    x, w = (x.clone() if x.data_ptr() % 16 else x), EncoderKernelWeights(
        *(t.clone() if t.data_ptr() % 16 else t for t in w))
    dev = x.device
    out = torch.empty((length, c), dtype=torch.float32, device=dev)
    if length == 0:
        return out
    xres = torch.empty((length, d), dtype=torch.float32, device=dev)
    qkv = torch.empty((3, n_heads, length, e), dtype=compute_dtype, device=dev)
    o = torch.empty((length, n_heads * e), dtype=compute_dtype, device=dev)
    is_bf16 = int(compute_dtype == torch.bfloat16)
    if lib.dpn_encoder_route(is_bf16, length, d, n_heads, e, f, c) and packed is None:
        packed = pack_encoder_weights(w)
    args = _EncoderArgs(*(t.data_ptr() for t in (x, *w, xres, qkv, o, out)),
                        length, d, n_heads, e, f, c, n_layers, int(activation == "gelu"), 1.0 / (e ** 0.5),
                        *((t.data_ptr() for t in packed) if packed is not None else (None, None)))
    with torch.cuda.device(dev):
        err = lib.dpn_encoder(is_bf16, ctypes.byref(args),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    fused_encoder_forward.launches += 1
    return out


fused_encoder_forward.launches = 0


@torch.no_grad()
def encode_fused(model, field_x: torch.Tensor, forecast_h: torch.Tensor) -> torch.Tensor:
    """Forward-only drop-in for ``PhysicsNet.encode``: [B, L, enc_in], [B, 1] -> tokens
    [B, ltn + L, c_out] float32 (the values of the compute dtype).  The embedding runs as
    PyTorch operators; the layers, final norm and projection in one launch per batch item.
    Activation and compute dtype follow the model.  The kernel computes full attention, so
    a model with ``attn_type='prob'`` raises ``ValueError`` where JAX's ``encode_fused``
    computes full attention without a word (C48); ``fused_qkv`` has the same parameters
    and the same product, so it makes no difference here."""
    net = model.meta_net.model
    attn_type = net.encoder.attn_layers[0].attention.attn_type
    if attn_type == "prob":
        raise ValueError("encode_fused: the fused encoder kernel computes full attention; "
                         f"the model has attn_type={attn_type!r}")
    xe = net.enc_embedding(field_x, forecast_h, net.learnable_token)  # [B, T, D] float32
    cdt = model.compute_dtype
    w = cast_encoder_weights(extract_encoder_weights(model), cdt)
    act = net.encoder.attn_layers[0].activation
    # the bf16 kernel's packed tiles, once for the batch (the CUDA-core body reads w in place)
    packed = pack_encoder_weights(w) if xe.device.type == "cuda" and cdt == torch.bfloat16 else None
    return torch.stack([fused_encoder_forward(w, xe[b], act, cdt, packed) for b in range(xe.shape[0])])
