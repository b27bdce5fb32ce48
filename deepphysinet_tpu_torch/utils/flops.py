"""FLOP accounting and MFU (model FLOP utilization) helpers.

Counterpart of ``deepphysinet_tpu/utils/flops.py``, with two counters that check
each other:

* ``compiled_flops`` -- PyTorch's count of the operators one call runs
  (``torch.utils.flop_counter.FlopCounterMode``).  A hand-written CUDA kernel is
  no PyTorch operator and counts ZERO, as a Pallas kernel does in XLA's count, so
  count the plain programs (``pde_engine='jvp'``, the ``*_ref`` decodes), which
  compute the same algebra;
* ``decode_jvp_v4_flops_per_point`` / ``decode_primal_v4_flops_per_point`` -- the
  analytic matmul counts of the collapsed v4 decode, copied from JAX.

MFU here = counted FLOPs / wall time / the card's dense bf16 peak.  Float32 work
is measured against the same peak, so an f32 MFU is conservative.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense bf16 peak FLOP/s by CUDA device name (NVIDIA H100 Tensor Core GPU datasheet: H100 SXM
# 989.4 TFLOP/s, H100 PCIe 756 TFLOP/s, without sparsity).  "H100 80GB HBM3" is the SXM part's name.
_PEAKS = (
    (("h100", "sxm"), 989e12),
    (("h100", "hbm3"), 989e12),
    (("h100", "pcie"), 756e12),
)


def chip_peak_flops(device=None) -> Optional[float]:
    """The card's dense bf16 peak for ``device`` (default: the current CUDA device).

    None on the CPU, without CUDA, or for a card not in the table: callers then skip
    MFU rather than print a bogus number."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    name = torch.cuda.get_device_name(device).lower()
    for keys, peak in _PEAKS:
        if all(k in name for k in keys):
            return peak
    return None


def compiled_flops(fn, *args, **kwargs) -> float:
    """PyTorch-counted FLOPs of one call ``fn(*args, **kwargs)`` (the call runs).

    CUDA kernels inside ``fn`` count as ZERO -- pass the plain program.  Matmul FLOPs
    are counted as 2*M*N*K whatever the dtype."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def decode_jvp_v4_flops_per_point(in_ch: int = 192, hidden: int = 256,
                                  n_vars: int = 6) -> float:
    """Analytic matmul+reduction FLOPs per collocation point of the collapsed
    v4 decode-with-tangents algebra (ops/decode_kernel.py:decode_jvp_v4_ref).

    Per variable: z = pe@w1 (in_ch->hid), tz = 3 channel dots
    (in_ch/3->hid), r = p@w2f1 (hid->hid) + cd_pe@wdf1 (in_ch->hid),
    tr = t@w2f1 (3x hid->hid), plus the fw2/w2wo/wdwo reduction epilogue.
    At (192, 256) this is ~0.824 MFLOP/pt/var -> ~4.94 MFLOP/pt.
    """
    z = 2 * in_ch * hidden
    tz = 3 * 2 * (in_ch // 3) * hidden
    r = 2 * hidden * hidden + 2 * in_ch * hidden
    tr = 3 * 2 * hidden * hidden
    epilogue = (2 * hidden            # sum(pr * fw2)
                + 2 * hidden          # sum(p * w2wo)
                + 2 * in_ch           # sum(cd_pe * wdwo)
                + 3 * 2 * hidden      # sum(tr * fw2)
                + 3 * 2 * hidden)     # sum(t * w2wo)
    return float(n_vars * (z + tz + r + tr + epilogue))


def decode_primal_v4_flops_per_point(in_ch: int = 192, hidden: int = 256,
                                     n_vars: int = 6) -> float:
    """Primal-only collapsed decode (engine.collapsed_decode): ~1.98 MFLOP/pt
    at (192, 256)."""
    z = 2 * in_ch * hidden
    r = 2 * hidden * hidden + 2 * in_ch * hidden
    epilogue = 2 * hidden + 2 * hidden + 2 * in_ch
    return float(n_vars * (z + r + epilogue))


def mfu(flops: float, seconds: float, device=None) -> Optional[float]:
    """Achieved fraction of the card's peak; None off CUDA or for an unknown card."""
    peak = chip_peak_flops(device)
    if peak is None or seconds <= 0:
        return None
    return flops / seconds / peak
