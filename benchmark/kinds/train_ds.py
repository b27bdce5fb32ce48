"""Device-sampled PDE training: ``train/device_sampling.py::make_device_sampling_train_step``.

Set-up builds one training object (the model with the seed's weights, Adam as the configuration
states it, the step), puts the traffic's windows on the device as row tables (as the trainer's
cube cache holds them after its first epoch), and drives the object through its first
``CHECKED_STEPS`` steps through the same call and feed as the window, then ``WARM_STEPS`` more.
The window then continues with the same object.  A step takes the next window in turn and fresh
draws, and ends with its total loss read on the host.

The comparison: the reference follows the first ``CHECKED_STEPS`` steps from the same weights,
windows and draws (``lib/checks.py::training_numbers``), and works out again the points of each,
which are held against the batch that the program's step consumed (``lib/checks.py::batch_gap``).
The batch is read where ``train/device_sampling.py::sample_batch`` hands it to the step, and the
first step's decoded fields where ``train/train_step.py::_variable_metrics`` takes them from the
loss, during the checked steps only.  Traffic keys: ``windows``, ``leads_h``, ``n_margin``, ``n_inter``,
``with_pde``, ``trace_steps``.
"""

from __future__ import annotations

import contextlib
import gc
import math
from typing import Dict
from unittest import mock

import torch

from benchmark.lib import checks, inputs, yardstick
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision
from benchmark.reference.physics import OMEGA
from benchmark.reference.sampler import geometry, inter_points, margin_points

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KERNELS = ("decode_jvp_v4s", "decode_bwd_v4s")
CHECKED_STEPS = 3
WARM_STEPS = 3


class State:
    pass


def _draws(d: Dict[str, torch.Tensor]):
    from deepphysinet_tpu_torch.train.device_sampling import Draws

    return Draws(mx=d["mx"][None], my=d["my"][None], slot=d["slot"][None], off=d["off"][None], ix=d["ix"][None],
                 iy=d["iy"][None], it=d["it"][None])


def build(cell, seed: int, device):
    """The program's training object and the run's inputs, before any step."""
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
    from deepphysinet_tpu_torch.train import device_sampling as ds
    from deepphysinet_tpu_torch.train.optim import build_optimizer
    from deepphysinet_tpu_torch.train.train_step import TrainState, step_config_from_cfg

    cfg, tr = cell.config, cell.traffic
    g = geometry(cfg)
    S = State()
    S.cell, S.seed, S.device = cell, seed, device
    S.w0 = inputs.weights(cfg, seed, device)
    model = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], compute_dtype=DTYPES[cell.dtype], device=device,
                       attn_impl=cfg["train_cfg"].get("tpu", {}).get("attn_impl"))
    model.load_state_dict(S.w0, strict=True)
    optimizer = build_optimizer(params=model.parameters(), **cfg["train_cfg"]["optimizer"])
    S.state = TrainState(step=0, model=model, optimizer=optimizer)
    scfg = ds.SamplerConfig(n_margin=int(tr["n_margin"]), n_inter=int(tr["n_inter"]), window_h=g.window_h,
                            input_time_step=g.input_step_h, label_time_step=g.label_step_h, begin_lat=g.lat0,
                            begin_lon=g.lon0, fine_step=g.fine_deg, coarse_step=g.coarse_deg)
    S.step_fn = ds.make_device_sampling_train_step(step_config_from_cfg(cfg), scfg)
    S.windows = inputs.windows(cfg, tr, seed, device)
    S.cubes = [ds.CubeBatch(field=w["field"][None], forecast_h=torch.tensor([w["lead_h"]], device=device),
                            nwp_cube=w["nwp_rows"], label_cube=w["label_rows"]) for w in S.windows]
    S.stream = inputs.DrawStream(cfg, tr["n_margin"], tr["n_inter"], seed, device)
    S.with_pde = bool(tr["with_pde"])
    S.points = int(tr["n_margin"]) + int(tr["n_inter"])
    S.n = 0
    S.kept = []  # (window index, draws) of the steps the reference follows
    return S


def step(S):
    w = S.n % len(S.cubes)
    d = S.stream.next()
    if len(S.kept) < CHECKED_STEPS:
        S.kept.append((w, {k: v.clone() for k, v in d.items()}))
    _, metrics = S.step_fn(S.state, S.cubes[w], _draws(d), S.with_pde)
    loss = float(metrics["total_loss"])
    S.n += 1
    S.last_metrics = metrics
    return S.points, math.isfinite(loss)


def point_rows(coords, f, nwp, labels, g) -> torch.Tensor:
    """One group of points as compared: [N, 3 + 1 + 6 (+ 6)] coordinates over the domain's extent,
    the Coriolis parameter over 2 Omega, the NWP conditioning and the labels as they are."""
    extent = torch.tensor([g.dx * (g.Wl - 1), g.dy * (g.Hl - 1), g.t_span_s], device=coords.device)
    cols = [coords.float() / extent, f.reshape(-1, 1).float() / (2 * OMEGA), nwp.float()]
    return torch.cat(cols + ([] if labels is None else [labels.float()]), dim=-1)


def _program_rows(batch, g) -> Dict[str, torch.Tensor]:
    def rows(p, labels):
        coords = torch.stack([p.x[0], p.y[0], p.t[0]], dim=-1)
        return point_rows(coords, p.f[0], p.nwp[0], p.labels[0] if labels else None, g)

    return dict(margin=rows(batch.margin, True), inter=rows(batch.inter, False))


def _reference_rows(window, draws, g) -> Dict[str, torch.Tensor]:
    m, i = margin_points(window, draws, g), inter_points(window, draws, g)
    return dict(margin=point_rows(m["coords"], m["f"], m["nwp"], m["labels"], g),
                inter=point_rows(i["coords"], i["f"], i["nwp"], None, g))


@contextlib.contextmanager
def _step_read(batches: list, fields: list, g):
    """Keep, for each step, the batch that the step's sampler hands it and the fields [N, 6] that
    its loss decoded at the labelled points."""
    from deepphysinet_tpu_torch.train import device_sampling as ds
    from deepphysinet_tpu_torch.train import train_step as ts

    sampler, variable_metrics = ds.sample_batch, ts._variable_metrics

    def read_batch(*args, **kwargs):
        batch = sampler(*args, **kwargs)
        batches.append(_program_rows(batch, g))
        return batch

    def read_fields(pred_norm, *args, **kwargs):
        fields.append(pred_norm[0].detach().float().clone())
        return variable_metrics(pred_norm, *args, **kwargs)

    with mock.patch.object(ds, "sample_batch", read_batch), mock.patch.object(ts, "_variable_metrics", read_fields):
        yield


def first_steps(S):
    """The checked steps, with the program's readings: each step's batch and loss, the first
    gradient as Adam received it, the parameters after the last."""
    model, opt = S.state.model, S.state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    terms, batches, fields = [], [], []
    with _step_read(batches, fields, geometry(S.cell.config)):
        for i in range(CHECKED_STEPS):
            step(S)
            terms.append({k: float(v) for k, v in S.last_metrics.items()})
            if i == 0:
                grad = {k: opt.state[p]["exp_avg"].detach().clone() / (1 - beta1) if p in opt.state
                        else torch.zeros_like(p) for k, p in model.named_parameters()}
    S.prog = dict(losses=[t["total_loss"] for t in terms], terms=terms, grad=grad, batches=batches, fields1=fields[0],
                  params={k: p.detach().clone() for k, p in model.named_parameters()})


def setup(cell, seed: int, device):
    S = build(cell, seed, device)
    first_steps(S)
    for _ in range(WARM_STEPS):
        step(S)
    return S


def work(S) -> Dict:
    tr = S.cell.traffic
    return dict(unit="points", per_step=S.points,
                model_flops=yardstick.train_step_flops(S.cell.config, 1, S.points),
                kernels={k: [int(tr["n_margin"]), int(tr["n_inter"])] for k in KERNELS})


def release(S):
    """Drop the program's objects before the reference runs."""
    for name in ("state", "step_fn", "cubes"):
        if hasattr(S, name):
            delattr(S, name)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(S):
    wins = [S.windows[w] for w, _ in S.kept]
    draws = [d for _, d in S.kept]
    return ref_train.run_steps(S.w0, S.cell.config, wins, draws, Precision("float32"))


def numbers(S) -> Dict:
    out = checks.training_numbers(S.prog, reference(S), S.w0)
    g = geometry(S.cell.config)
    want = [_reference_rows(S.windows[w], d, g) for w, d in S.kept]
    out["batch_gap"] = dict(value=checks.batch_gap(S.prog["batches"], want), steps=len(S.prog["batches"]))
    return out


def control_numbers(cell, seed: int, device, mode: str) -> Dict:
    """The reference computed in ``mode`` put in the program's place, on the same weights, windows
    and draws, against the float32 reference."""
    cfg, tr = cell.config, cell.traffic
    w0 = inputs.weights(cfg, seed, device)
    wins = inputs.windows(cfg, tr, seed, device)
    stream = inputs.DrawStream(cfg, tr["n_margin"], tr["n_inter"], seed, device)
    draws = [stream.next() for _ in range(CHECKED_STEPS)]
    ws = [wins[i % len(wins)] for i in range(CHECKED_STEPS)]
    ctrl = ref_train.run_steps(w0, cfg, ws, draws, Precision(mode))
    ref = ref_train.run_steps(w0, cfg, ws, draws, Precision("float32"))
    return checks.training_numbers(ctrl, ref, w0)
