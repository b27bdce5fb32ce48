"""Median times of the tensor-core decode kernels of the tree it runs in, for comparing two trees
on one card.

Random weights at flagship width (in_ch 192, hidden 256, six variables), bf16: the v4s and v6
pairs, the v4t forward and backward and the v2 forward at 20,480 points, the two residual-sum
kernels at 65,536 (the flagship's observation specs), and the forwards that take one frame, v3,
v4pe and v5, at its 37,265 points, each the median of five runs of ten launches (three for the
slower ones) by CUDA events.  It imports the port from the
working directory, so the same file times any tree.  Compare two trees in one call, in turns
(here the parent's checkout in ``parent/``):

    (cd parent && python3 ../deepphysinet_tpu_torch/diagnostics/decode_timing.py parent --outputs /tmp/p.pt)
    python3 deepphysinet_tpu_torch/diagnostics/decode_timing.py change --against /tmp/p.pt
    python3 deepphysinet_tpu_torch/diagnostics/decode_timing.py change
    (cd parent && python3 ../deepphysinet_tpu_torch/diagnostics/decode_timing.py parent)

Each prints one line: ``[decode timing] LABEL {kernel: ms, ...}``.  ``--outputs FILE`` saves each
kernel's outputs of its first launch; ``--against FILE`` prints, for each kernel in both, whether
this tree's outputs are bit-equal to the saved ones.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree to time: its package, not this file's

from deepphysinet_tpu_torch.config import Config  # noqa: E402
from deepphysinet_tpu_torch.ops import cuda_build, decode_kernel as dk, residual_kernel as rk  # noqa: E402
from deepphysinet_tpu_torch.ops.coords import CoordSpec  # noqa: E402
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe  # noqa: E402
from deepphysinet_tpu_torch.train.train_step import step_config_from_cfg  # noqa: E402

IN_CH, HID, N, RESIDUAL_N, FRAME_N = 192, 256, 20480, 65536, 145 * 257


OUTPUTS = {}  # kernel -> the outputs of its first launch (on the host)


def _tensors(out):
    """The tensors of a wrapper's result, in order (tuples and named tuples flattened)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in (out or ()) for t in _tensors(x)] if isinstance(out, (tuple, list)) else []


def median_ms(fn, iters: int = 10, name: str = "") -> float:
    out = fn()
    torch.cuda.synchronize()
    if name:
        OUTPUTS[name] = [t.cpu() for t in _tensors(out)]
    runs = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return round(statistics.median(runs), 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--outputs", help="save each kernel's outputs to this file")
    ap.add_argument("--against", help="hold each kernel's outputs to those saved in this file, bit for bit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_timing: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    cuda_build.build_libraries(list(dk.SOURCES) + [rk.SOURCE])
    rng = np.random.RandomState(11)

    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(dev)

    w1 = r(6, IN_CH, HID)
    fw = dk.FusedDecodeWeights(w1=w1, w1c=dk.slice_tangent_weights(w1), b1=r(6, HID), w2f1=r(6, HID, HID),
                               wdf1=r(6, IN_CH, HID), rbias=r(6, HID), fw2=r(6, HID), w2wo=r(6, HID),
                               wdwo=r(6, IN_CH), obias=r(6))
    spec = CoordSpec(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
    coords = torch.from_numpy(np.stack([rng.rand(N) * 27000 * 256, rng.rand(N) * 27000 * 144,
                                        rng.rand(N) * 86400.0], -1).astype(np.float32)).to(dev)
    cdata = r(N, 6, scale=0.3)
    pe, dpe = dk.pe_and_tangents(coords, spec, bf)
    dpe = dpe.contiguous()
    cd = sinecos_pe(cdata, make_freq_bands(16, 4.0)).to(bf).contiguous()
    pe_cm = dk.trig_cm_inputs(coords, spec, bf).contiguous()
    trig = dk.trig3_inputs(coords, spec, bf).contiguous()
    fw6 = dk.fuse_v6_from_v4(fw, spec)
    ref_t, g_p, g_t = r(6, N), r(6, N, scale=1.0), r(3, 6, N, scale=1.0)
    g_pn, g_tn = g_p.t().contiguous(), g_t.transpose(1, 2).contiguous()
    w = dk.DecodeWeights(w1=w1, b1=fw.b1, w2=r(6, HID, HID), b2=r(6, HID), wd=r(6, IN_CH, HID), bd=r(6, HID),
                         fh_add=r(6, HID), f1=r(6, HID, HID), g1=r(6, HID), f2=r(6, HID, HID), g2=r(6, HID),
                         wo=r(6, HID), bo=r(6))
    # the residual sums' points, and the flagship's observation specs
    coords_r = torch.from_numpy(np.stack([rng.rand(RESIDUAL_N) * 27000 * 256, rng.rand(RESIDUAL_N) * 27000 * 144,
                                          rng.rand(RESIDUAL_N) * 86400.0], -1).astype(np.float32)).to(dev)
    cdata_r, cor = r(RESIDUAL_N, 6, scale=0.3), r(RESIDUAL_N, 1, scale=1e-4)
    pe_r, dpe_r = dk.pe_and_tangents(coords_r, spec, bf)
    dpe_r, trig_r = dpe_r.contiguous(), dk.trig3_inputs(coords_r, spec, bf).contiguous()
    cd_r = sinecos_pe(cdata_r, make_freq_bands(16, 4.0)).to(bf).contiguous()
    # the in-kernel-PE forwards' raw points: one frame's worth
    coords_f = torch.from_numpy(np.stack([rng.rand(FRAME_N) * 27000 * 256, rng.rand(FRAME_N) * 27000 * 144,
                                          rng.rand(FRAME_N) * 86400.0], -1).astype(np.float32)).to(dev)
    cdata_f = r(FRAME_N, 6, scale=0.3)
    pe_f, dpe_f = dk.pe_and_tangents(coords_f, spec, bf)  # v5's prepared inputs of those points
    dpe_f, cd_f = dpe_f.contiguous(), sinecos_pe(cdata_f, make_freq_bands(16, 4.0)).to(bf).contiguous()
    specs = step_config_from_cfg(Config.fromfile(os.path.join(os.getcwd(), "configs", "DeepPhysiNet_NCEP_cfg.py"))
                                 ["config"]).obs_specs
    times = {
        "v4s_fwd": median_ms(lambda: dk.fused_decode_jvp_v4s(fw6, pe_cm, cd, ref_t, bf), name="v4s_fwd"),
        "v4s_bwd": median_ms(lambda: dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd, g_p, g_t, bf), name="v4s_bwd"),
        "v6_fwd": median_ms(lambda: dk.fused_decode_jvp_v6(fw6, trig, cd, ref_t.t().contiguous(), bf), name="v6_fwd"),
        "v6_bwd": median_ms(lambda: dk.decode_bwd_kernel_v6(fw6, trig, cd, g_pn, g_tn, bf), name="v6_bwd"),
        "v4t_fwd": median_ms(lambda: dk.fused_decode_jvp_v4t(fw, pe, dpe, cd, ref_t, bf), name="v4t_fwd"),
        "v4t_bwd": median_ms(lambda: dk.decode_bwd_kernel_v4t(fw, pe, dpe, cd, g_p, g_t, bf), iters=3, name="v4t_bwd"),
        "v2": median_ms(lambda: dk.fused_decode_jvp(w, pe, dpe, cd, cdata, bf), iters=3, name="v2"),
        "resid_v4": median_ms(lambda: rk.fused_residual_sums_v4(fw, pe_r, dpe_r, cd_r, cdata_r, cor, specs,
                                                                compute_dtype=bf), iters=3, name="resid_v4"),
        "resid_v6": median_ms(lambda: rk.fused_residual_sums_v6(fw6, trig_r, cd_r, cdata_r, cor, specs,
                                                                compute_dtype=bf), iters=3, name="resid_v6"),
        "v3": median_ms(lambda: dk.fused_decode_jvp_v3(w, coords_f, cdata_f, spec, bf), iters=3, name="v3"),
        "v4pe": median_ms(lambda: dk.fused_decode_jvp_v4pe(fw, coords_f, cdata_f, spec, bf), name="v4pe"),
        "v5": median_ms(lambda: dk.fused_decode_jvp_v5(fw, pe_f, dpe_f, cd_f, cdata_f, bf), iters=3, name="v5"),
    }
    print(f"[decode timing] {args.label} {json.dumps(times)}  ({torch.cuda.get_device_name(0)})", flush=True)
    if args.outputs:
        torch.save(OUTPUTS, args.outputs)
    if args.against:
        saved = torch.load(args.against)
        same = {k: len(v) == len(saved[k]) and all(torch.equal(a, b) for a, b in zip(v, saved[k]))
                for k, v in OUTPUTS.items() if k in saved}
        print(f"[decode timing] {args.label} outputs bit-equal to {os.path.basename(args.against)}'s: "
              f"{json.dumps(same)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
