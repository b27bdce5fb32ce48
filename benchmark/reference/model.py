"""DeepPhysiNet in plain PyTorch, float32: the encoder and the six coordinate MLPs.

Written from the model's description (arXiv 2401.04125) and the reference configuration's
shapes, with the numerics that the measured package states for itself: LayerNorm eps 1e-6, the
tanh form of GELU, post-norm encoder layers, the circular token convolution as one product of
its three taps.  Parameters live in a flat dict under the reference checkpoint's names (those of
``param_specs``), so that the same seeded weights load into the measured program by name.

Shapes (flagship): a window's token matrix [159, 2405] is embedded to d_model 256, 128
learnable tokens go in front, 4 encoder layers of 8 heads follow, and a projection gives
c_out 256.  Each of the six variable nets reads the first ``learnable_token_num`` (256) tokens
and generates from them the weights of its first two layers (192 -> 256 -> 256), adds the
encodings of the interpolated NWP values and of the lead time, runs a residual MLP and a scalar
head, and adds the variable's interpolated NWP value.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

VARIABLE_NETS = ("U_net", "V_net", "P_net", "T_net", "q_net", "rio_net")
LN_EPS = 1e-6
ENC = "meta_net.model."


def sizes(config: Mapping) -> Dict[str, int]:
    meta, net = config["meta_cfg"], config["net_cfg"]
    return dict(enc_in=int(meta["enc_in"]), c_out=int(meta["c_out"]), d_model=int(meta["d_model"]),
                n_heads=int(meta["n_heads"]), e_layers=int(meta["e_layers"]), d_ff=int(meta["d_ff"]),
                enc_tokens=int(meta.get("learnable_token_num", 128)), in_ch=int(net["in_channels"]),
                hidden=int(net["hidden_channels"]), token_num=int(net["token_num"]),
                hyper_tokens=int(net["learnable_token_num"]))


def param_specs(config: Mapping) -> "OrderedDict[str, Tuple[Tuple[int, ...], str, int]]":
    """name -> (shape, kind, fan_in): kind is ``dense`` (uniform +-1/sqrt(fan_in), weights and
    their biases), ``conv`` (normal, kaiming std with the leaky_relu(0.01) gain), ``token``
    (uniform [0, 1)), ``ln_w`` / ``ln_b`` (LayerNorm)."""
    s = sizes(config)
    d, dff = s["d_model"], s["d_ff"]
    out: "OrderedDict[str, Tuple[Tuple[int, ...], str, int]]" = OrderedDict()

    def dense(name, n_in, n_out, conv_like=False):
        out[name + ".weight"] = ((n_out, n_in, 1) if conv_like else (n_out, n_in), "dense", n_in)
        out[name + ".bias"] = ((n_out,), "dense", n_in)

    def ln(name):
        out[name + ".weight"] = ((d,), "ln_w", d)
        out[name + ".bias"] = ((d,), "ln_b", d)

    out[ENC + "enc_embedding.value_embedding.tokenConv.weight"] = ((d, s["enc_in"], 3), "conv", 3 * s["enc_in"])
    out[ENC + "enc_embedding.value_embedding.tokenConv.bias"] = ((d,), "dense", 3 * s["enc_in"])
    out[ENC + "learnable_token"] = ((1, s["enc_tokens"], d), "token", 1)
    for i in range(s["e_layers"]):
        p = f"{ENC}encoder.attn_layers.{i}."
        for proj in ("query", "key", "value", "out"):
            dense(p + f"attention.{proj}_projection", d, d)
        dense(p + "conv1", d, dff, conv_like=True)
        dense(p + "conv2", dff, d, conv_like=True)
        ln(p + "norm1")
        ln(p + "norm2")
    ln(ENC + "encoder.norm")
    dense(ENC + "projection", d, s["c_out"])
    for net in VARIABLE_NETS:
        dense(net + ".coord_input_fc", s["hyper_tokens"], s["in_ch"] + 1)
        dense(net + ".coord_hidden_fc", s["hyper_tokens"], s["hidden"] + 1)
        dense(net + ".data_input_fc", s["in_ch"], s["hidden"])
        dense(net + ".fore_h_fc", s["in_ch"], s["hidden"])
        dense(net + ".cat_fc1.fc.0", s["hidden"], s["hidden"])
        dense(net + ".cat_fc1.fc.2", s["hidden"], s["hidden"])
        dense(net + ".out_fc", s["hidden"], 1)
    return out


def freq_bands(n: int, max_freq: float = 4.0) -> np.ndarray:
    return (2.0 ** np.linspace(0.0, max_freq, n)).astype(np.float32)


def sinecos(x: torch.Tensor, bands: np.ndarray) -> torch.Tensor:
    """x [..., C] -> [..., F * 2 * C], features ordered (band, sin / cos, channel)."""
    fb = torch.as_tensor(bands, dtype=torch.float32, device=x.device)
    xf = (x.float()[..., None, :] * fb[:, None])  # [..., F, C]
    return torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(*x.shape[:-1], -1)


def position_table(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device) * -(math.log(10000.0) / d))
    table = torch.zeros(n, d, dtype=torch.float64, device=device)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table.float()


def linear(prec: Precision, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b for a [out, in] (or [out, in, 1]) weight."""
    w2 = w.reshape(w.shape[0], -1)
    return prec.mm(x, w2.t()) + b


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def encode(params: Mapping[str, torch.Tensor], config: Mapping, field: torch.Tensor, fh_norm: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """field [B, L, enc_in], fh_norm [B, 1] -> tokens [B, enc_tokens + L, c_out]."""
    s = sizes(config)
    B, L, C = field.shape
    d, h = s["d_model"], s["n_heads"]
    w = params[ENC + "enc_embedding.value_embedding.tokenConv.weight"]  # [d, C, 3]
    padded = torch.cat([field[:, -1:], field, field[:, :1]], dim=1)
    taps = torch.cat([padded[:, k:k + L] for k in range(3)], dim=-1)  # [B, L, 3C]: tap k reads x[l + k - 1]
    kernel = w.permute(2, 1, 0).reshape(3 * C, d)
    x = prec.mm(taps, kernel) + params[ENC + "enc_embedding.value_embedding.tokenConv.bias"]
    tok = params[ENC + "learnable_token"].expand(B, -1, -1)
    x = torch.cat([tok, x], dim=1)
    T = x.shape[1]
    x = x + position_table(T, d, x.device)[None] + sinecos(fh_norm, freq_bands(d // 2))[:, None, :]
    e = d // h
    for i in range(s["e_layers"]):
        p = f"{ENC}encoder.attn_layers.{i}."

        def proj(name, y):
            return linear(prec, y, params[p + f"attention.{name}_projection.weight"],
                          params[p + f"attention.{name}_projection.bias"])

        q, k, v = (proj(n, x).reshape(B, T, h, e).transpose(1, 2) for n in ("query", "key", "value"))
        scores = prec.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(e))
        att = prec.mm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, T, d)
        x = x + proj("out", att)
        x = layer_norm(x, params[p + "norm1.weight"], params[p + "norm1.bias"])
        y = linear(prec, x, params[p + "conv1.weight"], params[p + "conv1.bias"])
        y = F.gelu(y, approximate="tanh")
        y = linear(prec, y, params[p + "conv2.weight"], params[p + "conv2.bias"])
        x = layer_norm(x + y, params[p + "norm2.weight"], params[p + "norm2.bias"])
    x = layer_norm(x, params[ENC + "encoder.norm.weight"], params[ENC + "encoder.norm.bias"])
    return linear(prec, x, params[ENC + "projection.weight"], params[ENC + "projection.bias"])


def generated_layers(params, config, tokens: torch.Tensor, prec: Precision):
    """Each variable net's generated first two layers from one window's tokens [T, c_out]:
    a list of six (w1 [hid, in_ch], b1 [hid], w2 [hid, hid], b2 [hid])."""
    s = sizes(config)
    meta_t = tokens[: s["hyper_tokens"]].t()  # [c_out, hyper_tokens]
    out = []
    for net in VARIABLE_NETS:
        g1 = linear(prec, meta_t, params[net + ".coord_input_fc.weight"], params[net + ".coord_input_fc.bias"])
        g2 = linear(prec, meta_t, params[net + ".coord_hidden_fc.weight"], params[net + ".coord_hidden_fc.bias"])
        out.append((g1[:, : s["in_ch"]], g1[:, s["in_ch"]], g2[:, : s["hidden"]], g2[:, s["hidden"]]))
    return out


def coord_features(coords_norm: torch.Tensor, config: Mapping) -> torch.Tensor:
    """Normalized (x, y, t) [N, 3] -> the coordinate encoding [N, in_ch]."""
    return sinecos(coords_norm, freq_bands(sizes(config)["in_ch"] // 6))


def decode(params, config, layers, coord_pe: torch.Tensor, nwp: torch.Tensor, fh_norm: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """The six variables, normalized, at N points -> [N, 6].  ``coord_pe`` [N, in_ch], ``nwp`` [N, 6]
    the interpolated NWP values, ``fh_norm`` [1]."""
    s = sizes(config)
    cd_pe = sinecos(nwp, freq_bands(s["in_ch"] // 2 // 6))
    fh_pe = sinecos(fh_norm.reshape(1), freq_bands(s["in_ch"] // 2))
    cols = []
    for v, net in enumerate(VARIABLE_NETS):
        w1, b1, w2, b2 = layers[v]
        x = torch.relu(prec.mm(coord_pe, w1.t()) + b1)
        x = prec.mm(x, w2.t()) + b2
        x = x + linear(prec, cd_pe, params[net + ".data_input_fc.weight"], params[net + ".data_input_fc.bias"])
        x = x + linear(prec, fh_pe, params[net + ".fore_h_fc.weight"], params[net + ".fore_h_fc.bias"])
        y = torch.relu(linear(prec, x, params[net + ".cat_fc1.fc.0.weight"], params[net + ".cat_fc1.fc.0.bias"]))
        y = linear(prec, y, params[net + ".cat_fc1.fc.2.weight"], params[net + ".cat_fc1.fc.2.bias"])
        x = (y + x) + x
        cols.append(linear(prec, x, params[net + ".out_fc.weight"], params[net + ".out_fc.bias"]) + nwp[:, v:v + 1])
    return torch.cat(cols, dim=-1)
