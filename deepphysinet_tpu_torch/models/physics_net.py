"""PhysicsNet: the variable encoder + six hypernet-conditioned coordinate MLPs.

Counterpart of ``deepphysinet_tpu/models/physics_net.py``.  The JAX package
stacks the six VariableNets on a leading axis; the port keeps them as the
reference's six named modules (``U_net`` ... ``rio_net``) so that reference
checkpoints load strictly, and stacks their weights where the decode needs
them (``ops/decode_kernel.py::extract_decode_weights``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from deepphysinet_tpu_torch.device import resolve_device
from deepphysinet_tpu_torch.models.transformer_net import TransformerNet
from deepphysinet_tpu_torch.models.variable_net import VariableNet

# Output stacking order (reference physics_net.py:41-55): coord_data column v
# is the reference value for variable v in this order.
VARIABLE_ORDER = ("u", "v", "p", "T", "q", "rio")
# Reference attribute name of each variable's net, in VARIABLE_ORDER.
VARIABLE_NETS = ("U_net", "V_net", "P_net", "T_net", "q_net", "rio_net")


class MetaNet(nn.Module):
    """Holds the encoder under the reference's ``meta_net.model`` prefix."""

    def __init__(self, model: TransformerNet):
        super().__init__()
        self.model = model


class PhysicsNet(nn.Module):
    """``device=None`` places the parameters on the first CUDA device and raises
    when there is none; pass ``device="cpu"`` to build the model on the CPU."""

    def __init__(self, meta_cfg: Dict[str, Any], net_cfg: Dict[str, Any],
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.net_cfg = dict(net_cfg)
        self.compute_dtype = compute_dtype
        meta = {k: v for k, v in dict(meta_cfg).items()
                if k not in ("name", "dropout", "output_attention")}
        self.net_cfg.pop("name", None)
        self.meta_net = MetaNet(TransformerNet(compute_dtype=compute_dtype, device=device, **meta))
        for name in VARIABLE_NETS:
            setattr(self, name, VariableNet(
                net_cfg["learnable_token_num"], net_cfg["in_channels"],
                net_cfg["hidden_channels"], compute_dtype, device))

    def variable_nets(self) -> Tuple[VariableNet, ...]:
        return tuple(getattr(self, name) for name in VARIABLE_NETS)

    def encode(self, field_x: torch.Tensor, forecast_h: torch.Tensor) -> torch.Tensor:
        """[B, L, enc_in], [B, 1] -> tokens [B, ltn + L, c_out] (compute dtype)."""
        expected = self.net_cfg.get("token_num")
        if expected is not None and field_x.shape[1] != int(expected):
            # attention would silently accept a wrong-length sequence (e.g. a
            # field assembled without the constant rows); fail loudly instead
            raise ValueError(
                f"field has {field_x.shape[1]} tokens, net_cfg.token_num="
                f"{expected} (did the caller forget constant_variables?)")
        return self.meta_net.model(field_x, forecast_h)

    def decode(self, tokens: torch.Tensor, coord_pe: torch.Tensor,
               coord_data: torch.Tensor, fore_h: torch.Tensor) -> torch.Tensor:
        """All six variables at the query points -> [N, 6] (normalized units)."""
        cols = [net(tokens, coord_pe, coord_data, coord_data[:, v : v + 1], fore_h)
                for v, net in enumerate(self.variable_nets())]
        return torch.cat(cols, dim=-1)
