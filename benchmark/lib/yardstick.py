"""The fixed yardsticks: the card's published peaks, the roofline's least time, and the analytic
operation and byte counts of the model and of the decode kernels.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without sparsity), at its 700 W limit.

Model FLOPs (``mfu.*``) count the matrix products of the model as its layers are shaped, twice
a multiply-add, whatever a kernel does to compute them:

* encoder, per window: the token convolution (L x 3 enc_in x d), per layer the four projections
  (4 T d^2), the scores and the weighted sum (2 T^2 d), the feed-forward (2 T d d_ff), and the
  projection (T d c_out), with T = learnable + L tokens;
* the hypernetwork, per window and variable: the two generated layers, d x hyper_tokens x
  (in_ch + 1) and d x hyper_tokens x (hid + 1);
* the decode, per point and variable: layer 1 (in_ch x hid), layer 2 (hid^2), the NWP encoding
  (in_ch x hid), the residual MLP (2 hid^2) and the head (hid); the lead encoding once a window;
* training, at every point the residuals are taken at: three tangent directions through the
  layers that see the coordinates (layer 1, layer 2, the residual MLP, the head);
* training's backward: twice the forward.  Recomputation is not counted.

Kernel counts (``*_roofline``), per point, in multiply-adds of the collapsed decode that the
kernels compute (PERF.md's table of kernels), for in_ch = 3 x 2f and hidden h:

* decode_jvp_v4s: z (in_ch h) + the three tangents of z (3 x 2f x h) + r (h^2 + in_ch h) + the
  three tangents of r (3 h^2), a variable;
* decode_bwd_v4s: the forward's, + (4 h^2 + in_ch h) + 4 h^2 + (in_ch h + 3 x 2f x h), a variable;
* decode_primal: z (in_ch h) + r (h^2 + in_ch h) + the head's sums (2 h + in_ch), a variable.

Bytes count each input once as read and each output once as written: the per-point operands in
the compute type, the NWP reference and the outputs in float32, and the weights (compute type)
and the backward's weight gradients (float32) once a launch.
"""

from __future__ import annotations

from typing import Mapping

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
N_VARS = 6


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over the peak of the
    configuration's precision and bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def _dims(config: Mapping):
    meta, net = config["meta_cfg"], config["net_cfg"]
    return dict(L=int(net["token_num"]), C=int(meta["enc_in"]), d=int(meta["d_model"]), dff=int(meta["d_ff"]),
                layers=int(meta["e_layers"]), c_out=int(meta["c_out"]), T=int(meta.get("learnable_token_num", 128))
                + int(net["token_num"]), hyper=int(net["learnable_token_num"]), in_ch=int(net["in_channels"]),
                hid=int(net["hidden_channels"]))


def encoder_macs(config: Mapping) -> float:
    k = _dims(config)
    T, d = k["T"], k["d"]
    per_layer = 4 * T * d * d + 2 * T * T * d + 2 * T * d * k["dff"]
    return float(k["L"] * 3 * k["C"] * d + k["layers"] * per_layer + T * d * k["c_out"])


def hyper_macs(config: Mapping) -> float:
    k = _dims(config)
    return float(N_VARS * k["c_out"] * k["hyper"] * ((k["in_ch"] + 1) + (k["hid"] + 1)))


def decode_point_macs(config: Mapping) -> float:
    k = _dims(config)
    h = k["hid"]
    return float(N_VARS * (k["in_ch"] * h + h * h + k["in_ch"] * h + 2 * h * h + h))


def tangent_point_macs(config: Mapping) -> float:
    """One direction's tangent through the layers that see the coordinates."""
    k = _dims(config)
    h = k["hid"]
    return float(N_VARS * (k["in_ch"] * h + h * h + 2 * h * h + h))


def window_macs(config: Mapping) -> float:
    k = _dims(config)
    return encoder_macs(config) + hyper_macs(config) + float(N_VARS * k["in_ch"] * k["hid"])


def train_step_flops(config: Mapping, windows: int, points: int) -> float:
    """Model FLOPs of one PDE training step: forward, tangents at every point, backward."""
    fwd = windows * window_macs(config) + points * (decode_point_macs(config) + 3 * tangent_point_macs(config))
    return 2.0 * 3.0 * fwd


def frame_flops(config: Mapping, points: int) -> float:
    """Model FLOPs of one grid frame: one encode and the decode at every point."""
    return 2.0 * (window_macs(config) + points * decode_point_macs(config))


# ---- the decode kernels ----------------------------------------------------------------------


def _kernel_dims(config: Mapping):
    k = _dims(config)
    return k["in_ch"], k["hid"], k["in_ch"] // 3


def jvp_v4s_point_macs(config: Mapping) -> float:
    in_ch, h, two_f = _kernel_dims(config)
    return float(N_VARS * (in_ch * h + 3 * two_f * h + h * h + in_ch * h + 3 * h * h))


def bwd_v4s_point_macs(config: Mapping) -> float:
    in_ch, h, two_f = _kernel_dims(config)
    extra = (4 * h * h + in_ch * h) + 4 * h * h + (in_ch * h + 3 * two_f * h)
    return jvp_v4s_point_macs(config) + float(N_VARS * extra)


def primal_point_macs(config: Mapping) -> float:
    in_ch, h, _ = _kernel_dims(config)
    return float(N_VARS * (in_ch * h + h * h + in_ch * h + 2 * h + in_ch))


def _weight_elems(config: Mapping, family: str) -> float:
    in_ch, h, _ = _kernel_dims(config)
    if family == "decode_primal":
        return float(N_VARS * (2 * in_ch * h + h * h))
    return float(N_VARS * (3 * in_ch * h + h * h))


def kernel_launch(config: Mapping, family: str, points: int, dtype: str):
    """(FLOPs, bytes) of one launch of ``family`` over ``points`` points."""
    in_ch = _kernel_dims(config)[0]
    e = 2 if dtype == "bfloat16" else 4
    operands = points * 2 * in_ch * e + points * N_VARS * 4  # the coordinate and NWP rows, the reference
    weights = _weight_elems(config, family) * e
    if family == "decode_jvp_v4s":
        return 2.0 * points * jvp_v4s_point_macs(config), operands + weights + points * 4 * N_VARS * 4
    if family == "decode_bwd_v4s":
        cot = points * 4 * N_VARS * 4 - points * N_VARS * 4  # the cotangents replace the reference
        grads = _weight_elems(config, family) * 4
        return 2.0 * points * bwd_v4s_point_macs(config), operands + cot + weights + grads
    if family == "decode_primal":
        return 2.0 * points * primal_point_macs(config), operands + weights + points * N_VARS * 4
    raise KeyError(f"no counts for kernel family {family!r}")


def least_kernel_seconds(config: Mapping, family: str, launches, dtype: str) -> float:
    """The least time of a list of launches (points each)."""
    return sum(least_seconds(*kernel_launch(config, family, n, dtype), dtype) for n in launches)

