"""Grid inference: ``inference/runner.py::predict_grid``, one full label-grid frame a request.

Set-up loads the seed's weights into the program's model and makes the traffic's windows: the
token matrix on the device (held for the window's hours, as a service holds the window it
serves), the NWP cube on the host in the program's ``Window``.  Frame i takes window
(i // hours) mod windows at hour i mod hours, with the clip as the traffic says, and ends with the
six fields on the host.  Every frame's fields are kept until the run ends.

Set-up ends with ``WARM_FRAMES`` frames.  The comparison: after the window, ``CHECKED_FRAMES`` of
the completed frames, drawn from the seed (the last always among them), against the reference's
frame (``lib/checks.py::field_gap``).  Traffic keys: ``windows``, ``leads_h``, ``hours``,
``with_clip``, ``trace_steps``.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from benchmark.lib import checks, inputs, yardstick
from benchmark.reference import infer as ref_infer
from benchmark.reference import physics as P
from benchmark.reference.precision import Precision
from benchmark.reference.sampler import geometry

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
VARS = ("u", "v", "P", "T", "q", "rio")
WARM_FRAMES = 3
CHECKED_FRAMES = 16


class State:
    pass


def _program_window(cfg, win, g):
    from deepphysinet_tpu_torch.data.window import Window

    lon_c = g.lon0 + np.arange(g.Wc, dtype=np.float64) * g.coarse_deg
    lat_c = g.lat0 + np.arange(g.Hc, dtype=np.float64) * g.coarse_deg
    lon_f = g.lon0 + np.arange(g.Wl, dtype=np.float64) * g.fine_deg
    lat_f = g.lat0 + np.arange(g.Hl, dtype=np.float64) * g.fine_deg
    cube = win["nwp_rows"].reshape(g.Hc, g.Wc, g.Tc, 6).permute(3, 0, 1, 2).cpu().numpy()
    return Window(field=win["field"].cpu().numpy(), nwp_cube=np.ascontiguousarray(cube),
                  forecast_h=float(win["lead_h"]), in_lon=lon_c, in_lat=lat_c, out_lon=lon_f, out_lat=lat_f,
                  dx=g.dx, dy=g.dy, input_time_step=g.input_step_h,
                  input_time_step_nums=g.window_h // g.input_step_h, label_time_step=g.label_step_h,
                  forecast_time_period=g.lead_period_h)


def build(cell, seed: int, device):
    from deepphysinet_tpu_torch.inference.runner import decode_config_from_cfg
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet

    cfg, tr = cell.config, cell.traffic
    g = geometry(cfg)
    S = State()
    S.cell, S.seed, S.device, S.geometry = cell, seed, device, g
    S.w0 = inputs.weights(cfg, seed, device)
    S.model = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], compute_dtype=DTYPES[cell.dtype], device=device,
                         attn_impl=cfg["train_cfg"].get("tpu", {}).get("attn_impl"))
    S.model.load_state_dict(S.w0, strict=True)
    S.model.eval()
    S.dcfg = decode_config_from_cfg(cfg)
    S.windows = inputs.windows(cfg, tr, seed, device, labels=False)
    S.program_windows = [_program_window(cfg, w, g) for w in S.windows]
    S.fields = [w["field"][None] for w in S.windows]
    S.hours = int(tr["hours"])
    S.with_clip = bool(tr["with_clip"])
    S.n = 0
    S.keep = False
    S.frames = []  # (frame index, window, hour, [6, Hl, Wl] float32)
    return S


def frame_of(S, i: int):
    return (i // S.hours) % len(S.windows), i % S.hours


def step(S):
    from deepphysinet_tpu_torch.inference.runner import predict_grid

    w, hour = frame_of(S, S.n)
    try:
        out = predict_grid(S.model, S.dcfg, S.program_windows[w], S.fields[w], S.windows[w]["lead_h"],
                           float(hour), with_clip=S.with_clip, device=S.device)
        fields = np.stack([out[k] for k in VARS]).astype(np.float32, copy=False)
        ok = bool(np.isfinite(fields).all())
    except (RuntimeError, ValueError):
        fields, ok = None, False
    if S.keep and fields is not None:
        S.frames.append((S.n, w, hour, fields))
    S.n += 1
    return 1.0, ok


def setup(cell, seed: int, device):
    S = build(cell, seed, device)
    for _ in range(WARM_FRAMES):
        step(S)
    S.keep = True
    return S


def work(S) -> Dict:
    g = S.geometry
    return dict(unit="frames", per_step=1, model_flops=yardstick.frame_flops(S.cell.config, g.Hl * g.Wl),
                kernels={"decode_primal": [g.Hl * g.Wl]})


def release(S):
    for name in ("model",):
        if hasattr(S, name):
            delattr(S, name)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sampled(S):
    n = CHECKED_FRAMES
    if not S.frames:
        return []
    gen = inputs.generator(S.seed, inputs.SAMPLE, "cpu")
    order = torch.randperm(len(S.frames) - 1, generator=gen).tolist()[: max(0, n - 1)]
    return [S.frames[i] for i in sorted(order)] + [S.frames[-1]]


def reference_frames(S, frames, mode: str = "float32"):
    prec = Precision(mode)
    return [ref_infer.frame(S.w0, S.cell.config, S.windows[w], hour, prec) for _, w, hour, _ in frames]


def numbers(S) -> Dict:
    frames = sampled(S)
    if not frames:
        return dict(field_gap=dict(value=float("inf")))
    _, std, _, _ = P.norm_columns(S.cell.config, S.device)
    gap = 0.0
    for (_, _, _, got), want in zip(frames, reference_frames(S, frames)):
        got_t = torch.from_numpy(got.reshape(6, -1)).to(want.device)
        gap = max(gap, checks.field_gap(got_t, want, std.to(want.device)))
    return dict(field_gap=dict(value=gap, frames=len(frames)))


def control_numbers(cell, seed: int, device, mode: str) -> Dict:
    """The reference computed in ``mode`` in the program's place, at as many frames as a run
    compares, drawn from the seed among the window's (window, hour) pairs, against the float32
    reference."""
    cfg, tr = cell.config, cell.traffic
    S = State()
    S.cell, S.seed = cell, seed
    S.w0 = inputs.weights(cfg, seed, device)
    S.windows = inputs.windows(cfg, tr, seed, device, labels=False)
    hours = int(tr["hours"])
    gen = inputs.generator(seed, inputs.SAMPLE, "cpu")
    picks = torch.randperm(len(S.windows) * hours, generator=gen).tolist()[:CHECKED_FRAMES]
    frames = [(i, i // hours, i % hours, None) for i in picks]
    _, std, _, _ = P.norm_columns(cfg, device)
    gap = 0.0
    for got, want in zip(reference_frames(S, frames, mode), reference_frames(S, frames, "float32")):
        gap = max(gap, checks.field_gap(got, want, std))
    return dict(field_gap=dict(value=gap, frames=len(frames)))
