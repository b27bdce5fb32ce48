"""Token / positional / forecast-hour embeddings for the variable encoder.

Counterpart of ``deepphysinet_tpu/models/embed.py``.  The token embedding is
the reference's circular Conv1d(enc_in -> d_model, k=3) along the token axis,
computed as im2col plus one matmul (embed.py:53-61) rather than ``nn.Conv1d``:
cuDNN would run a float32 convolution in TF32 by default, and the matmul
follows the package's bf16-in / f32-accumulate rule.  The parameter keeps the
reference's ``tokenConv.weight`` shape [d_model, enc_in, 3]; tap k multiplies
x[l + k - 1], torch's cross-correlation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from deepphysinet_tpu_torch.models.init import kaiming_normal_std, normal_, uniform_
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.ops.precision import dot_f32


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """The PositionalEmbedding table (reference embed.py:20-31)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class _TokenConv(nn.Module):
    """Parameter holder with the reference Conv1d's names and shapes."""

    def __init__(self, c_in: int, d_model: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_model, c_in, 3, device=device))
        self.bias = nn.Parameter(torch.empty(d_model, device=device))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        fan_in = 3 * self.weight.shape[1]
        normal_(self.weight, kaiming_normal_std(fan_in), generator)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)


class TokenEmbedding(nn.Module):
    def __init__(self, c_in: int, d_model: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.tokenConv = _TokenConv(c_in, d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, L, C]; circular pad along L, then windows [B, L, 3*C] @ [3*C, D]
        b, l, c = x.shape
        xp = torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
        w = torch.stack([xp[:, :-2], xp[:, 1:-1], xp[:, 2:]], dim=2).reshape(b, l, 3 * c)
        kernel = self.tokenConv.weight.permute(2, 1, 0).reshape(3 * c, -1)
        return dot_f32(w, kernel, self.compute_dtype) + self.tokenConv.bias


class DataEmbedding(nn.Module):
    """Value embedding + prepended learnable tokens + positional and lead-time terms."""

    def __init__(self, c_in: int, d_model: int, max_len: int = 5000,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.value_embedding = TokenEmbedding(c_in, d_model, compute_dtype, device)
        self.register_buffer("pos_table", torch.as_tensor(sinusoid_table(max_len, d_model),
                                                          device=device), persistent=False)
        self._time_freqs = make_freq_bands(d_model // 2, max_freq=4.0)

    def forward(self, x: torch.Tensor, forecast_h: torch.Tensor,
                learnable_token: torch.Tensor) -> torch.Tensor:
        # x: [B, L, C_in]; forecast_h: [B, 1] normalized lead; token: [1, T, D]
        b = x.shape[0]
        x = self.value_embedding(x)
        tok = learnable_token.expand((b,) + learnable_token.shape[1:]).to(x.dtype)
        x = torch.cat([tok, x], dim=1)
        pos = self.pos_table[: x.shape[1]].to(x.dtype)
        time_emb = sinecos_pe(forecast_h, self._time_freqs)  # [B, D]
        return x + pos[None] + time_emb[:, None, :].to(x.dtype)
