"""Median times of the tensor-core decode kernels of the tree it runs in, for comparing two trees
on one card.

Random weights at flagship width (in_ch 192, hidden 256, six variables), 20,480 points, bf16:
the v4s and v6 pairs, the v4t forward and backward and the v2 forward, each the median of five
runs of ten launches (three for the two slowest) by CUDA events.  It imports the port from the
working directory, so the same file times any tree.  Compare two trees in one call, in turns
(here the parent's checkout in ``parent/``):

    (cd parent && python3 ../deepphysinet_tpu_torch/diagnostics/decode_timing.py parent)
    python3 deepphysinet_tpu_torch/diagnostics/decode_timing.py change
    python3 deepphysinet_tpu_torch/diagnostics/decode_timing.py change
    (cd parent && python3 ../deepphysinet_tpu_torch/diagnostics/decode_timing.py parent)

Each prints one line: ``[decode timing] LABEL {kernel: ms, ...}``.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree to time: its package, not this file's

from deepphysinet_tpu_torch.ops import cuda_build, decode_kernel as dk  # noqa: E402
from deepphysinet_tpu_torch.ops.coords import CoordSpec  # noqa: E402
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe  # noqa: E402

IN_CH, HID, N = 192, 256, 20480


def median_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
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
    if not torch.cuda.is_available():
        print("decode_timing: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    cuda_build.build_libraries(dk.SOURCES)
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
    times = {
        "v4s_fwd": median_ms(lambda: dk.fused_decode_jvp_v4s(fw6, pe_cm, cd, ref_t, bf)),
        "v4s_bwd": median_ms(lambda: dk.decode_bwd_kernel_v4s(fw6, pe_cm, cd, g_p, g_t, bf)),
        "v6_fwd": median_ms(lambda: dk.fused_decode_jvp_v6(fw6, trig, cd, ref_t.t().contiguous(), bf)),
        "v6_bwd": median_ms(lambda: dk.decode_bwd_kernel_v6(fw6, trig, cd, g_pn, g_tn, bf)),
        "v4t_fwd": median_ms(lambda: dk.fused_decode_jvp_v4t(fw, pe, dpe, cd, ref_t, bf)),
        "v4t_bwd": median_ms(lambda: dk.decode_bwd_kernel_v4t(fw, pe, dpe, cd, g_p, g_t, bf), iters=3),
        "v2": median_ms(lambda: dk.fused_decode_jvp(w, pe, dpe, cd, cdata, bf), iters=3),
    }
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    print(f"[decode timing] {label} {json.dumps(times)}  ({torch.cuda.get_device_name(0)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
