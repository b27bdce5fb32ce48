"""NeRF-style sine/cosine frequency encodings.

Counterpart of ``deepphysinet_tpu/ops/position_encoding.py``: log-spaced
frequency bands ``2**linspace(0, max_freq, N_freqs)`` and the feature layout
[..., F, {sin, cos}, C] flattened over the last three axes -- the order the
reference torch module produces, so generated hypernetwork weights see features
in identical positions.  Always evaluated in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def make_freq_bands(n_freqs: int, max_freq: float = 4.0, log_sampling: bool = True) -> np.ndarray:
    """Frequency bands, matching the reference utils/position_encoding.py:33-36."""
    if log_sampling:
        return np.asarray(2.0 ** np.linspace(0.0, max_freq, n_freqs), dtype=np.float32)
    return np.asarray(np.linspace(2.0**0.0, 2.0**max_freq, n_freqs), dtype=np.float32)


def sinecos_pe(x: torch.Tensor, freq_bands: np.ndarray, include_input: bool = False) -> torch.Tensor:
    """Encode ``x[..., C]`` -> ``[..., 2*F*C (+ C)]`` in float32."""
    x32 = x.float()
    fb = torch.as_tensor(freq_bands, dtype=torch.float32, device=x.device)
    xf = (x32[..., :, None] * fb).transpose(-1, -2)  # [..., F, C]
    emb = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, C]
    emb = emb.reshape(x.shape[:-1] + (-1,))
    if include_input:
        emb = torch.cat([x32, emb], dim=-1)
    return emb


def sinecos_pe_flat(x: torch.Tensor, freq_bands: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """``sinecos_pe(include_input=False)`` cast to ``dtype`` (the decode's matmul input)."""
    return sinecos_pe(x, freq_bands).to(dtype)


class SineCosPE:
    """Stateless callable carrying the band configuration (JAX position_encoding.py:70-95;
    the reference module's constructor, utils/position_encoding.py:13-14)."""

    def __init__(self, input_dim: int, N_freqs: int = 32, max_freq: float = 4.0,
                 log_sampling: bool = True, include_input: bool = True):
        self.input_dim = input_dim
        self.n_freqs = N_freqs
        self.include_input = include_input
        self.freq_bands = make_freq_bands(N_freqs, max_freq, log_sampling)
        self.out_dim = 2 * input_dim * N_freqs + (input_dim if include_input else 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return sinecos_pe(x, self.freq_bands, self.include_input)

    # reference-parity alias (torch modules are invoked via .forward)
    forward = __call__
