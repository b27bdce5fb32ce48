"""Hypernetwork-conditioned coordinate MLP (one output variable).

Counterpart of ``deepphysinet_tpu/models/variable_net.py`` with the reference
module names (``coord_input_fc``, ``coord_hidden_fc``, ``data_input_fc``,
``fore_h_fc``, ``cat_fc1.fc.{0,2}``, ``out_fc``).  The encoder's first
``token_num`` tokens generate the weights and biases of the first two layers;
the interpolated-NWP and forecast-lead encodings are added; a ResMLP trunk with
an extra skip and a scalar head follow; the output is a residual on the
interpolated NWP value.  This per-variable MLP is the plain decode; the
inference path uses the collapsed algebra of ``ops/decode_kernel.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from deepphysinet_tpu_torch.models.transformer_net import TorchDense
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.ops.precision import dot_f32


class ResMLP(nn.Module):
    """fc -> relu -> fc plus input skip (reference variable_net.py:13-26)."""

    def __init__(self, features: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            TorchDense(features, features, compute_dtype, device),
            nn.ReLU(),
            TorchDense(features, features, compute_dtype, device),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x) + x


class VariableNet(nn.Module):
    def __init__(self, token_num: int, in_channels: int, hidden_channels: int,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.token_num = token_num
        self.in_channels = in_channels
        self.hidden_channels = hidden_channels
        self.compute_dtype = compute_dtype
        self.coord_input_fc = TorchDense(token_num, in_channels + 1, compute_dtype, device)
        self.coord_hidden_fc = TorchDense(token_num, hidden_channels + 1, compute_dtype, device)
        self.data_input_fc = TorchDense(in_channels, hidden_channels, compute_dtype, device)
        self.fore_h_fc = TorchDense(in_channels, hidden_channels, compute_dtype, device)
        self.cat_fc1 = ResMLP(hidden_channels, compute_dtype, device)
        self.out_fc = TorchDense(hidden_channels, 1, compute_dtype, device)

    def forward(
        self,
        meta_out: torch.Tensor,  # [tokens, d_model] encoder output for this window
        coord_pe: torch.Tensor,  # [N, in_channels]
        coord_data: torch.Tensor,  # [N, 6] interpolated NWP values
        ref_data: torch.Tensor,  # [N, 1] this variable's interpolated NWP value
        fore_h: torch.Tensor,  # [1] normalized forecast lead
    ) -> torch.Tensor:
        cd = self.compute_dtype
        meta_t = meta_out[0 : self.token_num].t()  # [d_model, token_num]
        w = self.coord_input_fc(meta_t)
        w1, b1 = w[:, : self.in_channels], w[:, self.in_channels]
        w = self.coord_hidden_fc(meta_t)
        w2, b2 = w[:, : self.hidden_channels], w[:, self.hidden_channels]

        x = dot_f32(coord_pe, w1.t(), cd).to(cd) + b1.to(cd)
        x = torch.relu(x)
        x = dot_f32(x, w2.t(), cd).to(cd) + b2.to(cd)

        pe6 = make_freq_bands(self.in_channels // 2 // 6, max_freq=4.0)
        coord_data_pe = self.data_input_fc(sinecos_pe(coord_data, pe6))
        pe1 = make_freq_bands(self.in_channels // 2, max_freq=4.0)
        fore_h_pe = self.fore_h_fc(sinecos_pe(fore_h, pe1))

        cat_x = x + coord_data_pe + fore_h_pe
        x = self.cat_fc1(cat_x) + cat_x
        x = self.out_fc(x)
        return x.float() + ref_data.float()
