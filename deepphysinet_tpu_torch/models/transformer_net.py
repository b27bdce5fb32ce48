"""The variable encoder: post-norm transformer over grid-variable tokens.

Counterpart of ``deepphysinet_tpu/models/transformer_net.py``, with the module
names of the reference torch model (``enc_embedding``, ``learnable_token``,
``encoder.attn_layers.{i}.{attention,conv1,conv2,norm1,norm2}``,
``encoder.norm``, ``projection``) so a reference state_dict loads strictly.

Numerics pinned to the JAX package rather than to torch's defaults:

* ``TorchDense`` rounds the float32-accumulated product to the compute dtype
  before adding the bias (transformer_net.py:46-54);
* LayerNorm eps is 1e-6 (flax's default; the reference torch model uses 1e-5);
* gelu is the tanh form (``jax.nn.gelu``'s default);
* the encoder layers are post-norm (transformer_net.py:154-164).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepphysinet_tpu_torch.models.embed import DataEmbedding
from deepphysinet_tpu_torch.models.init import uniform_
from deepphysinet_tpu_torch.ops.attention import fused_attention
from deepphysinet_tpu_torch.ops.prob_attention import prob_attention
from deepphysinet_tpu_torch.ops.precision import dot_f32

LAYER_NORM_EPS = 1e-6


class TorchDense(nn.Module):
    """Linear layer with the reference ``nn.Linear`` names ([out, in] weight).

    The product is taken in float32 from compute-dtype inputs, rounded to the
    compute dtype, and the bias is added in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(self.weight_shape(in_features, out_features),
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    @staticmethod
    def weight_shape(in_features: int, out_features: int):
        return (out_features, in_features)

    def kernel(self) -> torch.Tensor:
        """The [in, out] matrix the input multiplies."""
        return self.weight.t()

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.kernel().shape[0])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return dot_f32(x, self.kernel(), cd).to(cd) + self.bias.to(cd)


class PointwiseConv(TorchDense):
    """A kernel-size-1 Conv1d used as a dense layer: weight [out, in, 1]."""

    @staticmethod
    def weight_shape(in_features: int, out_features: int):
        return (out_features, in_features, 1)

    def kernel(self) -> torch.Tensor:
        return self.weight[:, :, 0].t()


class AttentionLayer(nn.Module):
    """QKV projections + attention + output projection (reference attn.py:161-196).

    ``attn_type='full'`` runs full attention, whose forward ``attn_impl`` picks
    (``ops/attention.py::fused_attention``: ``None`` automatic, ``'xla'``, ``'pallas'``,
    ``'flash'``); ``attn_type='prob'`` runs ProbSparse attention
    (``ops/prob_attention.py``), whatever ``attn_impl`` says; any other value is full
    attention, as in JAX (transformer_net.py:127-133).  ``fused_qkv=True`` takes q, k and v
    in one [d, 3d] product of the three projections' weights concatenated at call time
    (transformer_net.py:104-118): the same parameters and names, so checkpoints load either
    way."""

    def __init__(self, d_model: int, n_heads: int, compute_dtype=torch.float32, device=None,
                 attn_impl: Optional[str] = None, attn_type: str = "full", fused_qkv: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.attn_type = attn_type
        self.fused_qkv = fused_qkv
        self.compute_dtype = compute_dtype
        self.query_projection = TorchDense(d_model, d_model, compute_dtype, device)
        self.key_projection = TorchDense(d_model, d_model, compute_dtype, device)
        self.value_projection = TorchDense(d_model, d_model, compute_dtype, device)
        self.out_projection = TorchDense(d_model, d_model, compute_dtype, device)

    def qkv(self, x: torch.Tensor):
        """The three projections of ``x`` [B, L, d], each [B, L, d] in the compute dtype."""
        projections = (self.query_projection, self.key_projection, self.value_projection)
        if not self.fused_qkv:
            return tuple(p(x) for p in projections)
        cd = self.compute_dtype
        w = torch.cat([p.kernel() for p in projections], dim=1)  # [d, 3d]
        bias = torch.cat([p.bias for p in projections])
        return (dot_f32(x, w, cd).to(cd) + bias.to(cd)).chunk(3, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h = self.n_heads
        e = d // h
        q, k, v = (t.reshape(b, l, h, e) for t in self.qkv(x))
        if self.attn_type == "prob":
            out = prob_attention(q, k, v, scale=1.0 / (e**0.5))
        else:
            out = fused_attention(q, k, v, 1.0 / (e**0.5), self.attn_impl)
        return self.out_projection(out.reshape(b, l, h * e))


class EncoderLayer(nn.Module):
    """Post-norm block: attention residual -> LN -> pointwise FFN -> LN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str = "gelu",
                 compute_dtype=torch.float32, device=None, attn_impl: Optional[str] = None,
                 attn_type: str = "full", fused_qkv: bool = False):
        super().__init__()
        self.activation = activation
        self.attention = AttentionLayer(d_model, n_heads, compute_dtype, device, attn_impl,
                                        attn_type, fused_qkv)
        self.conv1 = PointwiseConv(d_model, d_ff, compute_dtype, device)
        self.conv2 = PointwiseConv(d_ff, d_model, compute_dtype, device)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(x)
        y = x = self.norm1(x.float())
        y = self.conv1(y)
        y = F.relu(y) if self.activation == "relu" else F.gelu(y, approximate="tanh")
        y = self.conv2(y)
        return self.norm2((x + y).float())


class Encoder(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, e_layers: int,
                 activation: str = "gelu", compute_dtype=torch.float32, device=None,
                 attn_impl: Optional[str] = None, attn_type: str = "full", fused_qkv: bool = False):
        super().__init__()
        self.attn_layers = nn.ModuleList([
            EncoderLayer(d_model, n_heads, d_ff, activation, compute_dtype, device, attn_impl,
                         attn_type, fused_qkv)
            for _ in range(e_layers)])
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.attn_layers:
            x = layer(x)
        return self.norm(x.float())


class EncoderStack(nn.Module):
    """Informer-style pyramid of encoders on progressively halved inputs (JAX
    transformer_net.py:167-196; present but unused in the reference): encoder i runs
    ``e_layers`` post-norm layers of full attention on the last ``L // 2**inp_lens[i]``
    tokens, and the outputs are concatenated on the token axis.  The layers keep JAX's
    names, ``stack_{i}_layer_{j}``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, e_layers: int, inp_lens=(0, 1),
                 activation: str = "gelu", compute_dtype=torch.float32, device=None):
        super().__init__()
        self.inp_lens = tuple(inp_lens)
        self.e_layers = e_layers
        for i in range(len(self.inp_lens)):
            for j in range(e_layers):
                self.add_module(f"stack_{i}_layer_{j}", EncoderLayer(
                    d_model, n_heads, d_ff, activation, compute_dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, i_len in enumerate(self.inp_lens):
            y = x[:, -(x.shape[1] // 2**i_len):, :]
            for j in range(self.e_layers):
                y = getattr(self, f"stack_{i}_layer_{j}")(y)
            outs.append(y)
        return torch.cat(outs, dim=1)


class TransformerNet(nn.Module):
    """The full encoder: ``forward(x_enc [B, L, enc_in], forecast_h [B, 1])
    -> [B, learnable_token_num + L, c_out]`` in the compute dtype."""

    def __init__(self, enc_in: int, c_out: int, d_model: int = 512, n_heads: int = 8,
                 e_layers: int = 6, d_ff: int = 512, activation: str = "gelu",
                 learnable_token_num: int = 128, compute_dtype=torch.float32, device=None,
                 attn_impl: Optional[str] = None, attn_type: str = "full", fused_qkv: bool = False):
        super().__init__()
        self.enc_embedding = DataEmbedding(enc_in, d_model, compute_dtype=compute_dtype,
                                           device=device)
        self.learnable_token = nn.Parameter(
            torch.empty(1, learnable_token_num, d_model, device=device))
        self.encoder = Encoder(d_model, n_heads, d_ff, e_layers, activation,
                               compute_dtype, device, attn_impl, attn_type, fused_qkv)
        self.projection = TorchDense(d_model, c_out, compute_dtype, device)

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        t = torch.rand(self.learnable_token.shape, generator=generator)
        with torch.no_grad():
            self.learnable_token.copy_(t)

    def forward(self, x_enc: torch.Tensor, forecast_h: torch.Tensor) -> torch.Tensor:
        x = self.enc_embedding(x_enc, forecast_h, self.learnable_token)
        return self.projection(self.encoder(x))
