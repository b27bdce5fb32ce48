"""Informer ProbSparse self-attention.

Counterpart of ``deepphysinet_tpu/ops/prob_attention.py`` (:23-63), the encoder's
``attn_type='prob'``: the top-u queries by the sparsity measure m = max - mean of
their scores against a sample of keys attend fully; the rest take the value mean.
The JAX function has no Pallas kernel, so this is plain PyTorch, step for step:

* u and u_part are ``factor * ceil(ln L)`` (at most L);
* the key sample is JAX's: the JAX encoder always draws it with
  ``jax.random.randint(PRNGKey(0), (L_q, u_part), 0, L_k)`` (no caller passes a
  ``'sample'`` rng), the same indices on every call.  ``randint`` below is a numpy
  copy of that draw (threefry2x32 and ``randint``'s two-word algorithm, under
  ``jax_threefry_partitionable=True``, jax 0.9's default), computed once per
  shape on the host and kept on the device (``sample_indices``);
* ``jax.lax.top_k`` takes the lower index first among equal values, and m is a
  bf16 tensor in a bf16 model, so ties are common: a stable descending sort keeps
  that order (``torch.topk`` promises none);
* the roundings of a bf16 model are JAX's: each einsum's float32 sum rounded to the
  compute dtype, the scale rounded to it before it multiplies the scores,
  ``jnp.mean`` summed in float32 and rounded, the softmax of ``jax.nn.softmax``
  (exp and division in the compute dtype, the sum in float32).

Gradients come from autograd through the gathers and the scatter, as JAX's come from its
autodiff of the same primitives.  In bf16 they round otherwise: XLA on the CPU sums a bf16
cotangent (the transposes of the broadcasts) in bf16, one term after another, where
PyTorch sums in float32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.precision import dot_f32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of counts ``(x1, x2)`` under key ``(k1, k2)``: 20 rounds, a key
    injection every four (jax ``prng._threefry2x32_lowering``)."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_iota(key: Tuple[int, int], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The hash of the 64-bit counts 0..n-1 (high and low words), as jax's partitionable
    threefry feeds them."""
    counts = np.arange(n, dtype=np.uint64)
    return threefry2x32(key[0], key[1], (counts >> np.uint64(32)).astype(np.uint32),
                        (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words, for a seed in [0, 2**32)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    return 0, seed


def split(key: Tuple[int, int], num: int = 2):
    """``jax.random.split(key, num)`` as a list of keys."""
    a, b = _hash_iota(key, num)
    return [(int(a[i]), int(b[i])) for i in range(num)]


def random_bits32(key: Tuple[int, int], shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: the two hash words XORed."""
    a, b = _hash_iota(key, int(np.prod(shape)))
    return (a ^ b).reshape(shape)


def randint(key: Tuple[int, int], shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` with jax's default int32: two words of
    random bits a value, reduced modulo the span in uint32 arithmetic."""
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    span = max(maxval - minval, 1)
    multiplier = 2**16 % span
    multiplier = (multiplier * multiplier % 2**32) % span
    span, multiplier = np.uint32(span), np.uint32(multiplier)
    offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _sample_on(l_q: int, u_part: int, l_k: int, device: str) -> torch.Tensor:
    return torch.from_numpy(randint(prng_key(0), (l_q, u_part), 0, l_k).astype(np.int64)).to(device)


def sample_indices(l_q: int, u_part: int, l_k: int, device) -> torch.Tensor:
    """The key sample of the JAX encoder, [L_q, u_part] int64 on ``device``: the same tensor on
    every call with these sizes (C47)."""
    return _sample_on(l_q, u_part, l_k, str(torch.device(device)))


def top_counts(l_q: int, l_k: int, factor: int = 5) -> Tuple[int, int]:
    """(u, u_part): the queries that attend fully and the keys a query samples."""
    u_part = min(int(factor * math.ceil(math.log(max(l_k, 2)))), l_k)
    u = min(int(factor * math.ceil(math.log(max(l_q, 2)))), l_q)
    return u, u_part


def _einsum_round(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """A JAX einsum of compute-dtype inputs: float32 sums, rounded to the compute dtype."""
    return dot_f32(a, b, cd).to(cd)


def _mean_round(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: summed in float32, rounded to the input's dtype."""
    return x.float().mean(dim, keepdim=keepdim).to(x.dtype)


def _softmax_like_jax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in ``x``'s dtype: exp and division in that dtype,
    the sum of the exponentials in float32; no gradient through the max (JAX stops it)."""
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.float().sum(-1, keepdim=True).to(x.dtype)


def sparsity_measure(q: torch.Tensor, k: torch.Tensor, factor: int = 5) -> torch.Tensor:
    """m = max - mean of each query's scores against its sampled keys: [B, H, L_q] in q's dtype."""
    cd = q.dtype
    l_q, l_k = q.shape[1], k.shape[1]
    _, u_part = top_counts(l_q, l_k, factor)
    qh, kh = q.transpose(1, 2), k.transpose(1, 2)  # [B, H, L, E]
    k_sample = kh[:, :, sample_indices(l_q, u_part, l_k, q.device)]  # [B, H, L_q, u_part, E]
    qk = _einsum_round(qh.unsqueeze(-2), k_sample.transpose(-1, -2), cd).squeeze(-2)  # [B, H, L_q, u_part]
    return qk.amax(-1) - _mean_round(qk, -1)


def top_queries(q: torch.Tensor, k: torch.Tensor, factor: int = 5) -> torch.Tensor:
    """The queries that attend fully: [B, H, u] indices, by ``sparsity_measure``, largest
    first, the lower index first among ties."""
    u, _ = top_counts(q.shape[1], k.shape[1], factor)
    m = sparsity_measure(q, k, factor)
    return torch.sort(m, dim=-1, descending=True, stable=True).indices[..., :u]


def prob_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, factor: int = 5,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q, k: [B, L, H, E], v: [B, L_k, H, D] -> [B, L_q, H, D] in ``v``'s dtype."""
    b, l_q, h, e = q.shape
    d = v.shape[-1]
    cd = v.dtype
    scale = scale or 1.0 / math.sqrt(e)
    top = top_queries(q, k, factor)  # [B, H, u]
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q_reduce = torch.gather(qh, 2, top[..., None].expand(-1, -1, -1, e))  # [B, H, u, E]
    # JAX multiplies by the scale as a weak-typed constant: rounded to the scores' dtype first
    scale_q = torch.tensor(scale, dtype=q.dtype).item()
    scores = _einsum_round(q_reduce, kh.transpose(-1, -2), q.dtype) * scale_q  # [B, H, u, L_k]
    top_ctx = _einsum_round(_softmax_like_jax(scores).to(cd), vh, cd)  # [B, H, u, D]
    ctx = _mean_round(vh, 2, keepdim=True).expand(b, h, l_q, d)
    ctx = ctx.scatter(2, top[..., None].expand(-1, -1, -1, d), top_ctx)
    return ctx.transpose(1, 2)
