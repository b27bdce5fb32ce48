"""Full softmax attention: the plain path and two hand-written Hopper kernels.

Counterpart of ``deepphysinet_tpu/ops/attention.py``.  Every call goes through
``fused_attention`` (:192-221), whose forward is one of three functions, each
with its own rounding:

* ``attention_xla`` (:40-45): the plain path.  Scores and softmax in float32,
  the probabilities rounded to ``v``'s dtype before the second product;
* ``attention_tile`` (``_attention_pallas`` / ``_attn_kernel``, :48-92): the
  single-tile kernel, the same function as ``attention_xla``; its plain version
  is ``attention_tile_ref``;
* ``attention_flash`` (``_attention_flash`` / ``_flash_kernel``, :95-167): the
  online-softmax kernel over 256-key blocks.  The UNNORMALISED probabilities are
  rounded to ``v``'s dtype for the product and the sum is divided out at the end,
  so in bf16 it rounds elsewhere than the other two; its plain version is
  ``attention_flash_ref``.

``attention_tile`` and ``attention_flash`` launch ``csrc/attention.cu`` on a CUDA
tensor (or raise) and run their plain versions on a CPU tensor; each counts its
launches in ``launches``.

Routing (``default_impl``, ``fused_attention``) follows JAX's with one
translation: JAX's "on the TPU" is the port's "on a CUDA device".  ``impl=None``
runs the plain path up to ``_XLA_SEQ_THRESHOLD`` tokens and the kernels above;
``'pallas'`` runs the single-tile kernel up to ``_FLASH_THRESHOLD`` tokens and
the flash kernel above; ``'flash'`` always runs the flash kernel; ``'xla'`` the
plain path.  On the CPU ``impl=None`` is always the plain path, as JAX's is off
the TPU.  The flagship encoder has 287 tokens, so its default is the plain path.

The backward (``FusedAttention``) is the plain-PyTorch counterpart of
``_fused_bwd`` (:208-218), whatever the forward: JAX's is XLA, not a kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from deepphysinet_tpu_torch.ops.precision import dot_f32

SOURCE = "attention.cu"

# sequences longer than this leave the single-tile kernel for the flash kernel
_FLASH_THRESHOLD = 1024
# at or below this length the automatic choice stays on the plain path
_XLA_SEQ_THRESHOLD = 1024
# the flash kernel's key block (the TPU kernel's block_k): it sets where the
# unnormalised probabilities round, so the CUDA kernel and its plain version use it too
FLASH_BLOCK = 256


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)  # [B, L, H, E] -> [B, H, L, E]


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v: [B, L, H, E] -> [B, L, H, E] in ``v``'s dtype (no mask)."""
    cd = v.dtype
    scores = dot_f32(_heads_first(q), k.permute(0, 2, 3, 1), cd)  # [B, H, L, S]
    a = torch.softmax(scale * scores, dim=-1)
    out = dot_f32(a, _heads_first(v), cd)  # [B, H, L, E]
    return out.to(cd).permute(0, 2, 1, 3)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 q.kT (inputs as they come) times ``scale``: [B, H, Lq, Lk]."""
    return torch.matmul(_heads_first(q).float(), k.permute(0, 2, 3, 1).float()) * scale


def attention_tile_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of the single-tile kernel (``_attn_kernel``): float32 scores and
    softmax over all keys, the probabilities rounded to ``v``'s dtype, the product
    summed in float32 and rounded to ``q``'s dtype."""
    s = _scores(q, k, scale)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.matmul(a.float(), _heads_first(v).float())
    return out.to(q.dtype).permute(0, 2, 1, 3)


def attention_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        block_q: int = FLASH_BLOCK, block_k: int = FLASH_BLOCK) -> torch.Tensor:
    """Plain version of the flash kernel (``_flash_kernel``) with its rounding: per key
    block, ``p = exp(s - m_cur)`` rounded to ``v``'s dtype for the product while the
    unrounded ``p`` adds into the running sum ``l``; ``acc / l`` at the end.  Query
    rows are independent, so ``block_q`` only sizes the work; ``block_k`` sets the
    rounding."""
    b, length, h, e = q.shape
    vh = _heads_first(v).float()
    out = torch.empty((b, h, length, e), dtype=q.dtype, device=q.device)
    for i in range(0, length, block_q):
        qi = q[:, i:i + block_q]
        m = torch.full((b, h, qi.shape[1], 1), -torch.inf, device=q.device)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros((b, h, qi.shape[1], e), device=q.device)
        for j in range(0, length, block_k):
            s = _scores(qi, k[:, j:j + block_k], scale)
            m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_cur)
            alpha = torch.exp(m - m_cur)
            l_sum = alpha * l_sum + p.sum(-1, keepdim=True)
            m = m_cur
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vh[:, :, j:j + block_k])
        out[:, :, i:i + block_q] = (acc / l_sum).to(q.dtype)
    return out.permute(0, 2, 1, 3)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library; declare its C signatures."""
    from deepphysinet_tpu_torch.ops.cuda_build import load_library

    lib = load_library(SOURCE)
    vp = ctypes.c_void_p
    lib.dpn_attention.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, vp]
    lib.dpn_attention.restype = ctypes.c_int
    lib.dpn_attention_supports_head_dim.argtypes = [ctypes.c_int]
    lib.dpn_attention_supports_head_dim.restype = ctypes.c_int
    lib.dpn_attention_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.dpn_attention_plan.restype = ctypes.c_int
    return lib


def launch_plan(q: torch.Tensor, flash: bool) -> dict:
    """The launch ``csrc/attention.cu`` makes for a CUDA tensor q [B, L, H, E]: warps a
    block, blocks, dynamic shared memory in bytes, and whether all of a head's K and V stay
    in shared memory (``resident``)."""
    b, length, h, e = q.shape
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(q.device):
        err = _library().dpn_attention_plan(int(q.dtype == torch.bfloat16), b, length, h, e, int(flash), out)
    if err != 0:
        raise RuntimeError(f"launch_plan: CUDA error {err}")
    return dict(zip(("warps", "blocks", "smem_bytes", "resident"), (int(x) for x in out)))


def _launch(wrapper, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            flash: bool) -> torch.Tensor:
    """Checks and one launch of ``csrc/attention.cu`` (CUDA tensors only)."""
    name = wrapper.__name__
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    for nm, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {nm} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"q {tuple(q.shape)} {q.dtype} on {q.device}")
    b, length, h, e = q.shape
    lib = _library()
    if not lib.dpn_attention_supports_head_dim(e):
        raise ValueError(f"{name}: head width {e} not supported (16, 32 or 64)")
    # 16-byte loads: a view that starts off a 16-byte boundary is copied
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    # on q's device and its current stream.  At the encoder's size the host's work per call
    # outlasts the kernel (PERF.md), so the device is switched only when q is not on the
    # current one, and the stream is read raw rather than through a Stream object.
    idx = q.device.index
    with contextlib.nullcontext() if idx == torch.cuda.current_device() else torch.cuda.device(idx):
        err = lib.dpn_attention(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), out.data_ptr(), b, length, h, e, scale, int(flash),
                                torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    wrapper.launches += 1
    return out


def attention_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The single-tile kernel: q, k, v [B, L, H, E] -> [B, L, H, E] in q's dtype.
    CPU tensors take ``attention_tile_ref``; a CUDA tensor launches the kernel or
    raises.  ``attention_tile.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_tile_ref(q, k, v, scale)
    return _launch(attention_tile, q, k, v, scale, flash=False)


def attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The flash kernel over ``FLASH_BLOCK``-key blocks: q, k, v [B, L, H, E] ->
    [B, L, H, E] in q's dtype.  CPU tensors take ``attention_flash_ref``; a CUDA
    tensor launches the kernel or raises.  ``attention_flash.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return attention_flash_ref(q, k, v, scale)
    return _launch(attention_flash, q, k, v, scale, flash=True)


attention_tile.launches = 0
attention_flash.launches = 0


def default_impl(seq_len: Optional[int] = None, device=None) -> str:
    """``'xla'`` off a CUDA device and up to ``_XLA_SEQ_THRESHOLD`` tokens, else ``'pallas'``."""
    if device is None or torch.device(device).type != "cuda":
        return "xla"
    if seq_len is not None and seq_len <= _XLA_SEQ_THRESHOLD:
        return "xla"
    return "pallas"


def _forward(q, k, v, scale: float, impl: Optional[str]) -> torch.Tensor:
    impl = impl or default_impl(q.shape[1], q.device)
    if impl == "flash":
        return attention_flash(q, k, v, scale)
    if impl == "pallas":
        if q.shape[1] > _FLASH_THRESHOLD:
            return attention_flash(q, k, v, scale)
        return attention_tile(q, k, v, scale)
    return attention_xla(q, k, v, scale)


class FusedAttention(torch.autograd.Function):
    """``fused_attention``'s custom VJP: the forward chosen by ``impl``, the backward
    of ``_fused_bwd`` with JAX's rounding.  ``a`` is recomputed in float32 from the
    saved q, k, v; it is rounded to the cotangent's dtype for ``dv``; ``da`` is
    taken in the compute dtype; ``ds`` is rounded to q's dtype before ``dq`` and
    ``dk``, which are scaled by ``scale`` in their own dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, impl: Optional[str]):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale, impl)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = ctx.scale
        qh, kh, vh, gh = (_heads_first(x) for x in (q, k, v, g))  # [B, H, L, E]
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        a = torch.softmax(scale * scores, dim=-1)  # float32 [B, H, L, S]
        dv = torch.matmul(a.to(g.dtype).float().transpose(-1, -2), gh.float()).to(g.dtype)
        da = torch.matmul(gh.float(), vh.float().transpose(-1, -2)).to(g.dtype)
        ds = a * (da - (da * a).sum(-1, keepdim=True))
        ds = ds.to(q.dtype).float()
        dq = scale * torch.matmul(ds, kh.float()).to(q.dtype)
        dk = scale * torch.matmul(ds.transpose(-1, -2), qh.float()).to(q.dtype)
        back = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731
        return back(dq), back(dk), back(dv), None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q, k, v: [B, L, H, E] -> [B, L, H, E].  ``impl``: ``None`` (automatic, see
    ``default_impl``), ``'xla'``, ``'pallas'`` or ``'flash'``."""
    return FusedAttention.apply(q, k, v, scale, impl)
