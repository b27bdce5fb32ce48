"""How near a bf16 rounding tie the v2 kernel's sums of z and c must lie to be summed again.

The bf16 v2 forward (``csrc/decode_jvp_v2.cu``) adds its products on the tensor cores in another
order than cuBLAS, whose f32 product the plain version uses (one FMA a term in k order), so a
value near a bf16 rounding tie can round the other way; the kernel sums z and c again in cuBLAS's
order where they lie within ``TIE_ULPS`` ulps, or within ``TIE_FLOOR`` times the largest |value| of
the warp's 32 columns of the row, of a tie.  This script emulates the kernel's sums on the card
(each k16 chunk's 16 exact products rounded once to f32, the chunks added in f32 in k order, as
the kernel's ``warp_mma`` adds them for z and c) on the flagship model's decode weights of the
first 20,480 margin points of the seeded batch, as ``chip_smoke.py`` builds them, and prints for
z (T(p)) and c (T(c)): the elements whose rounding differs from cuBLAS's, the largest
|emulated - cuBLAS| in units of 2^-24 times that largest value, and for floors of 8 to 32 such
units the values the window flags a block of 64 points and variable and the differing ones it
misses.

Run from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.tie_window
"""
from __future__ import annotations

import sys

import torch

TIE_ULPS = 32  # csrc/decode_jvp_v2.cu
FLOORS = (8, 16, 20, 24, 32)  # in units of 2^-24 times the largest |value| of the warp's 32 columns
EPS = 2.0 ** -24


def emulated(x, y, bf=torch.bfloat16):
    """x @ y as the kernel adds it: each k16 chunk's exact products summed and rounded to f32
    once, the chunks added in f32 in k order."""
    x, y = x.to(bf).double(), y.to(bf).double()
    acc = None
    for c0 in range(0, x.shape[-1], 16):
        d = torch.matmul(x[..., c0:c0 + 16], y[..., c0:c0 + 16, :]).float()
        acc = d if acc is None else acc + d
    return acc


def window_reading(name, tc, seq, rounds, blocks):
    bf = torch.bfloat16
    differ = rounds(tc).to(bf) != rounds(seq).to(bf)
    bits = tc.view(torch.int32)
    low = ((bits & 0xFFFF) - 0x8000).abs()
    ulp = torch.ldexp(torch.ones_like(tc), (torch.frexp(tc.abs())[1] - 24).to(torch.int32))
    dist = low.float() * ulp
    rows = tc.abs().reshape(*tc.shape[:-1], -1, 32).amax(-1, keepdim=True)
    m32 = rows.expand(*rows.shape[:-1], 32).reshape(tc.shape)
    live = rounds(tc) != 0
    worst = float(((tc - seq).abs() / (EPS * m32.clamp_min(1e-30))).max())
    parts = []
    for g in FLOORS:
        flag = live & ((low <= TIE_ULPS) | (dist <= g * EPS * m32))
        parts.append(f"{g}: {int(flag.sum()) / blocks:.1f} flagged, {int((differ & ~flag).sum())} missed")
    print(f"[tie window] {name}: {int(differ.sum())} of {tc.numel()} elements round otherwise than cuBLAS's; "
          f"|emulated - cuBLAS| at most {worst:.2f} x 2^-24 x the row's largest |value| of the warp's columns; "
          f"window of {TIE_ULPS} ulps or a floor of (per block and variable) " + "; ".join(parts), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tie_window: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the repository's root is on the path under ``python -m``
    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch
    from deepphysinet_tpu_torch.ops import decode_kernel as dk
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf, n = torch.device("cuda"), torch.bfloat16, 20480
    cfg = Config.fromfile(cs.FLAGSHIP_CFG)["config"]
    state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                  torch.Generator().manual_seed(0), compute_dtype=bf, device=dev,
                                  attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
    scfg = ts.step_config_from_cfg(cfg)
    batch = ts.batch_to_device(synthetic_batch(cfg, seed=0), device=dev)
    with torch.no_grad():
        fh = (batch.forecast_h / scfg.forecast_time_period)[:, None]
        tokens = state.model.encode(batch.field, fh)[0]
        m = batch.margin
        coords = torch.stack([m.x[0, :n], m.y[0, :n], m.t[0, :n]], dim=-1)
        w, pe, _, cd = engine._kernel_inputs(state.model, tokens, coords, m.nwp[0, :n], fh[0], scfg.coord_spec)
        pe, cd = pe.to(bf), cd.to(bf)
        blocks = w.w1.shape[0] * n / 64
        z_seq = dk.dot_f32(pe, w.w1, bf) + w.b1[:, None, :]
        window_reading("z (T(p))", emulated(pe, w.w1) + w.b1[:, None, :], z_seq, torch.relu, blocks)
        p = torch.relu(z_seq).to(bf).float()  # cuBLAS's T(p): c's inputs as the plain version has them
        c_tc = ((emulated(p, w.w2) + w.b2[:, None, :]) + (emulated(cd, w.wd) + w.bd[:, None, :])) + w.fh_add[:, None, :]
        c_seq = ((dk.dot_f32(p, w.w2, bf) + w.b2[:, None, :]) + (dk.dot_f32(cd, w.wd, bf) + w.bd[:, None, :])
                 + w.fh_add[:, None, :])
        window_reading("c (T(c))", c_tc, c_seq, lambda x: x, blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
