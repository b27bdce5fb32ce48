"""The port against the JAX package at the flagship width, through a record.

The card has no jax, so what the JAX package computes at the width the port runs comes to it as a
record: ``flagship_record.npz`` beside this file, written on the CPU by
``JAX_PLATFORMS=cpu python tests/test_torch_port_flagship.py --write`` from the weights and inputs
made here.  ``chip_smoke.py`` (its phase 24b) and the ``slow`` tests of that file read it.

The flagship is ``configs/DeepPhysiNet_NCEP_cfg.py``: 128 learnable + 159 field tokens, d_model 256,
4 encoder layers, six variable nets 256 wide.  Everything is made from one seed with numpy's legacy
generator, never ``torch.Generator``, so that no torch version changes a weight or an input:

* ``seeded_state_dict``: every parameter of the port's ``state_dict()``, in sorted name order, at
  the scales of ``models/init.py`` (uniform +-1/sqrt(fan_in), the token convolution's kaiming
  normal, learnable tokens U[0, 1)); LayerNorm weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), so
  that no norm is the identity;
* ``flagship_inputs``: ``synthetic_batch`` of the seed (one window, 20,480 + 4,096 points) and of
  the next seed (the second window of a B = 2 batch), the 40,960-point residual set drawn as
  ``bench.py`` (:104-116) draws it after its batch, and one 145 x 257 frame of ``synthetic_window``
  at ``FRAME_HOUR`` with its conditioning interpolated once on the host.

The readings, per compute dtype (the record holds float32 and bfloat16; R6 float32 only):

* R1 ``tokens``: the encoded tokens of the batch's window, [287, 256];
* R2 ``frame``: ``predict_grid``'s physical fields of the frame, [6, 37,265], every
  ``FRAME_STRIDE``-th point kept;
* R3 ``v4s_primal`` / ``v4s_tangents``: ``fused_kernel_fields_t(version=7)`` at the batch's 4,096
  collocation points, [6, N] and [3, 6, N];
* R4 ``residual``: ``fused_residual_losses(version=7)`` at the 40,960 points, the six terms and
  the total;
* R5 ``step``: one PDE step of the batch (B = 1): every metric, the global gradient norm before
  the clip, each parameter's gradient norm, ``PROBES`` seeded probes <g, r> of each parameter's
  gradient (r of unit length, ``probe_vectors``), and the norm and probes of each parameter's
  change after the clip and the coupled-L2 Adam update;
* R6 ``b2`` / ``micro``: R5 for the B = 2 batch of both windows, and for its two windows as two
  B = 1 micro-batches, gradients and metrics averaged before one update.

``port_readings`` takes them through the port's entry points: on the card the kernel paths (the
``'kernel'`` engine, version 7: the primal decode kernel for R2, the v4s forward kernel for R3 and
R4, the v4s pair for R5 and R6); on the CPU their plain versions.  ``compare`` holds them to the
record: each item's error (each variable, term or parameter; ``KINDS``) against its bar, the larger
of ``FLOORS`` and ``SPREAD_TIMES`` times the item's JAX spread (the largest of what equivalent JAX
computations part from it by on the same inputs, written into the record beside each reading).
What the bars allow for, and how it is still shown: C13's switched points (``OUTLIER_SHARE`` of a
row, held to ``OUTLIER_CAP``), Adam's sign flips (``FLIP_SHARE``, ``FLIP_PER_GRAD``), C4's noise
parameters (``NOISE_PARAMETERS``, held to ``ZERO_GRAD_NOISE`` of the gradient norm) and items that
JAX's own forms cannot fix (``UNDETERMINED``, reported beside the reading).  ``b2_micro_rows``
answers phase 24 (b)'s question: the port's B = 2 step against its two micro-batches beside JAX's.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_CFG = os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py")
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flagship_record.npz")

SEED = 0
FRAME_HOUR = 6.5  # the frame's time offset in the window, hours
FRAME_STRIDE = 4  # every 4th of the frame's 37,265 points is kept in the record
RESIDUAL_POINTS = 40960  # bench.py's residual-evaluation batch
PROBES = 8  # probes of each parameter's gradient and change
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEP_PARTS = ("metrics", "grad_norm", "leaf_norms", "grad_probes", "step_norms", "step_probes")

# Each reading's error, by kind (``reading_errors``):
#   "array"   the largest |port - JAX| over the largest |JAX| (one item);
#   "rows"    the same for each row of the last axis (each variable, tangent direction), leaving
#             out the OUTLIER_SHARE of the row's points with the largest errors, which are held to
#             OUTLIER_CAP of the row's largest |JAX| instead, or to the row's bar where that is wider: a relu argument within rounding of zero switches one point's
#             tangents (C13; in float32 up to 4.2e-2 of a row's largest tangent, one point of
#             4,096 for u10 and one for q2, in the port's plain versions against the record), and
#             a bf16 rounding flipped across a tie moves one output (C42);
#   "scalars" |port - JAX| / |JAX| for each entry (each loss term, metric, parameter's norm);
#   "probes"  the largest |port - JAX| of a parameter's PROBES probes over the typical size of a
#             probe, the parameter's JAX norm / sqrt(its entries) (one item a parameter).
KINDS = {"tokens": "array", "frame": "rows", "v4s_primal": "rows", "v4s_tangents": "rows",
         "residual": "scalars", "metrics": "scalars", "grad_norm": "scalars",
         "leaf_norms": "scalars", "grad_probes": "probes", "step_norms": "scalars",
         "step_probes": "probes"}
# The floors of the bars, by reading and dtype.  float32: summation order alone (TF32 off) moves
# a decode output by a few 1e-7 of its scale and a step's gradients by up to 1e-5; the floors
# leave a factor of about 10 above that, and stay below the 1e-3 change that one of rio_net's
# weight matrices scaled by 1 + 1e-3 makes in R3 to R5.  bfloat16: one rounding step is 7.8e-3
# of a value, and a flipped rounding carried through the encoder moves a step's gradients by up
# to 1.13 of their largest entry (C17): torch's bf16 sums on the CPU put the learnable tokens'
# gradient 0.143 of a probe from JAX's where JAX's own forms part by 0.022, so the bf16
# gradient floors are 0.25.
FLOORS = {
    "float32": {"tokens": 1e-4, "frame": 1e-4, "v4s_primal": 1e-4, "v4s_tangents": 1e-4,
                "residual": 1e-4, "metrics": 1e-4, "grad_norm": 1e-4, "leaf_norms": 1e-3,
                "grad_probes": 1e-3, "step_norms": 1e-3, "step_probes": 3e-2},
    "bfloat16": {"tokens": 2e-2, "frame": 2e-2, "v4s_primal": 2e-2, "v4s_tangents": 5e-2,
                 "residual": 5e-2, "metrics": 5e-2, "grad_norm": 5e-2, "leaf_norms": 2.5e-1,
                 "grad_probes": 2.5e-1, "step_norms": 5e-2, "step_probes": 2e-1},
}
SPREAD_TIMES = 4.0  # chip_smoke.py's rule for C17: four times what JAX's own forms part by
OUTLIER_SHARE = 1e-3  # of a "rows" reading's points: at most 4 of 4,096, 9 of the frame's 9,317
OUTLIER_CAP = 0.25
# Adam's first step is lr * sign(g) (coupled L2 adds weight_decay * p, which the flagship's
# clipped gradients dwarf), so an entry whose gradient lies within the two packages' difference
# of zero steps either way (C4, C6).  A probe of a parameter of n entries moves by about
# 2 sqrt(k / n) of its typical size when k entries flip.  A gradient held within a relative
# bar e (its "grad_probes" bar) flips about FLIP_PER_GRAD * e of its entries (the share of a
# normal sample within e of zero); the bar of "step_probes" allows that share, FLIP_SHARE, or one
# entry, whichever is most: 4 sqrt(share).
FLIP_SHARE = {"float32": 1e-3, "bfloat16": 1e-2}
FLIP_PER_GRAD = 0.8
# Softmax is invariant to the key-projection biases, so their exact gradient is zero and what
# either package computes is rounding noise that Adam turns into full steps of either sign (C4).
# They are left out of the gradient norms and probes and held instead to ZERO_GRAD_NOISE of the
# global gradient norm, as chip_smoke.py's phase 6 holds them; their update norms stay held.
NOISE_PARAMETERS = ("key_projection.bias",)
ZERO_GRAD_NOISE = 1e-5
# An item that JAX's own equivalent forms part on by this much of its scale is not determined at
# the dtype's precision, and no multiple of one sample of that spread bounds another: in bf16 the
# rio_net gradients, which points whose density rounds to within bf16's resolution of its clip
# floor carry through 1/rho (C6, C17; JAX's forms part by 0.8-1.0 of a norm).  Such items are
# reported beside the reading, not held; the float32 readings hold the same parameters.
UNDETERMINED = 0.5


def flagship_config() -> Dict[str, Any]:
    from deepphysinet_tpu_torch.config import Config

    return Config.fromfile(FLAGSHIP_CFG)["config"]


# ---- weights and inputs ------------------------------------------------------------------------


def seeded_state_dict(model: torch.nn.Module, seed: int = SEED) -> Dict[str, torch.Tensor]:
    """Every entry of ``model.state_dict()`` drawn from ``np.random.RandomState(seed)``, in sorted
    name order, as float32 CPU tensors."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if name.endswith("learnable_token"):
            a = rng.random_sample(shape)
        elif ".norm" in name or name.split(".")[-2].startswith("norm"):  # LayerNorm
            a = rng.standard_normal(shape) * 0.1 + (1.0 if name.endswith(".weight") else 0.0)
        else:
            w_shape = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shape
            fan_in = int(np.prod(w_shape[1:]))
            if name.endswith("tokenConv.weight"):  # kaiming normal, leaky_relu(0.01) gain
                a = rng.standard_normal(shape) * math.sqrt(2.0 / (1.0 + 0.01 ** 2)) / math.sqrt(fan_in)
            else:
                a = rng.uniform(-1.0, 1.0, shape) / math.sqrt(fan_in)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def _residual_set(cfg: Mapping[str, Any], seed: int) -> Dict[str, np.ndarray]:
    """The residual-evaluation points of ``bench.py`` (:104-116): its generator continues after
    the batch's draws (``synthetic_batch``'s, in the same order), so those are drawn again first."""
    img = cfg["train_cfg"]["img_size"]
    lat_n, lon_n = (int(img), int(img)) if isinstance(img, (int, float)) else map(int, img)
    data_cfg = cfg["train_cfg"]["train_data"]
    rng = np.random.RandomState(seed)
    for n in (int(data_cfg["label_batch_size"]), int(data_cfg["batch_size_inter"])):
        rng.rand(1, n), rng.rand(1, n), rng.randint(0, 25, (1, n)), rng.rand(1, n, 1)
        rng.randn(1, n, 6), rng.randn(1, n, 6)
    rng.randn(1, int(cfg["net_cfg"]["token_num"]), int(cfg["meta_cfg"]["enc_in"]))
    n = RESIDUAL_POINTS
    coords = np.stack([rng.rand(n) * 27000 * (lon_n - 1), rng.rand(n) * 27000 * (lat_n - 1),
                       rng.randint(0, 25, n) * 3600.0], axis=-1).astype(np.float32)
    f = (1e-4 * rng.rand(n, 1)).astype(np.float32)
    nwp = (rng.randn(n, 6) * 0.1).astype(np.float32)
    return dict(coords=coords, f=f, nwp=nwp)


def flagship_inputs(cfg: Mapping[str, Any], seed: int = SEED) -> Dict[str, Any]:
    """The record's inputs, as numpy: ``batch`` (B = 1) and ``batch2`` (B = 2, the batch's window
    then the next seed's), ``residual`` (coords [N, 3], f [N, 1], nwp [N, 6]), ``frame`` (the
    frame's field [1, 159, 2405], lead, hour and x, y, t, nwp of its points) and ``window``."""
    from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window

    b0, b1 = synthetic_batch(cfg, seed), synthetic_batch(cfg, seed + 1)
    cat = lambda a, b: np.concatenate([a, b], axis=0)  # noqa: E731
    batch2 = dict(field=cat(b0["field"], b1["field"]), forecast_h=cat(b0["forecast_h"], b1["forecast_h"]),
                  **{g: {k: cat(b0[g][k], b1[g][k]) for k in b0[g]} for g in ("margin", "inter")})
    window = synthetic_window(cfg, seed)
    (lat_n, lon_n) = (window.out_lat.size, window.out_lon.size)
    xs, ys = np.meshgrid(np.arange(lon_n, dtype=np.float64), np.arange(lat_n, dtype=np.float64))
    x_l, y_l = xs.reshape(-1), ys.reshape(-1)
    px, py, pt, nwp, _ = window.get_margin_grid(x_l, y_l, np.full(x_l.shape, FRAME_HOUR))
    frame = dict(field=window.field[None], forecast_h=np.float32(window.forecast_h), x=px, y=py, t=pt,
                 nwp=nwp)
    return dict(batch=b0, batch2=batch2, residual=_residual_set(cfg, seed), frame=frame, window=window)


def input_arrays(inputs: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The input arrays by flat name (``batch.margin.x``, ``frame.nwp``, ...)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else k, node[k])
        elif isinstance(node, (np.ndarray, np.floating)):
            out[prefix] = np.asarray(node)

    walk("", {k: v for k, v in inputs.items() if k != "window"})
    return out


def checksum(a) -> str:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def checksums(state_dict: Mapping[str, Any], inputs: Mapping[str, Any]) -> Dict[str, str]:
    """sha256 (first 16 hex digits) of each weight (``weight/NAME``) and input array
    (``input/NAME``)."""
    out = {f"weight/{k}": checksum(v) for k, v in sorted(state_dict.items())}
    out.update({f"input/{k}": checksum(v) for k, v in input_arrays(inputs).items()})
    return out


# ---- reductions shared by both packages' sides ---------------------------------------------------


def probe_vectors(name: str, size: int, seed: int = SEED) -> np.ndarray:
    """PROBES unit vectors [PROBES, size] (float64) for the parameter ``name``, drawn from a
    generator seeded by the seed and the name's CRC-32."""
    rng = np.random.RandomState((zlib.crc32(name.encode()) + 7919 * seed) % (2 ** 32))
    r = rng.standard_normal((PROBES, size))
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def step_readings(metrics: Mapping[str, float], grad_norm: float, grads: Mapping[str, np.ndarray],
                  change: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One step's readings from its metrics, its global gradient norm before the clip, each
    parameter's gradient and change (numpy, reference names): the parts of ``STEP_PARTS``, the
    metrics and parameters in sorted name order (the record's ``metrics`` and ``parameters``)."""
    norms, probes = {"grad": [], "step": []}, {"grad": [], "step": []}
    for k in sorted(grads):
        r = probe_vectors(k, np.size(grads[k]))
        for part, a in (("grad", grads[k]), ("step", change[k])):
            a = np.asarray(a, np.float64).reshape(-1)
            norms[part].append(np.linalg.norm(a))
            probes[part].append(r @ a)
    return dict(metrics=np.array([metrics[k] for k in sorted(metrics)], np.float64),
                grad_norm=np.array([grad_norm], np.float64),
                leaf_norms=np.array(norms["grad"]), grad_probes=np.stack(probes["grad"]),
                step_norms=np.array(norms["step"]), step_probes=np.stack(probes["step"]))


STEP_METRICS_SKIPPED = ("grad_norm", "skipped_nonfinite")  # grad_norm is a reading of its own


# ---- the port's side ---------------------------------------------------------------------------


def port_model(cfg: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype,
               device=None):
    """A ``TrainState`` of the flagship at ``dtype`` on ``device`` (``None``: the card) holding
    ``state_dict``, with the configuration's optimizer."""
    from deepphysinet_tpu_torch.train import train_step as ts

    state = ts.create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                                  torch.Generator().manual_seed(0), compute_dtype=dtype, device=device,
                                  attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))
    state.model.load_state_dict(state_dict)
    return state


def _port_step(state, cfg, scfg, batches, device) -> Dict[str, np.ndarray]:
    """R5 of one step: ``batches`` [numpy batch dicts] go through ``make_loss_fn`` one after the
    other (two for R6's micro-batches: each loss halved before its backward, the metrics
    averaged), then ``apply_gradient_update``: the step of ``make_train_step``, with the gradient
    read before the clip."""
    from deepphysinet_tpu_torch.train import train_step as ts

    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    loss_fn = ts.make_loss_fn(model, scfg)
    per_batch, preds, labels = [], [], []
    for nb in batches:
        batch = ts.batch_to_device(nb, device=device)
        total, (metrics, pred_norm) = loss_fn(batch, True)
        (total / len(batches)).backward()
        per_batch.append({k: float(v.detach()) for k, v in metrics.items()})
        preds.append(pred_norm.detach())
        labels.append(batch.margin.labels)
    names = [k for k, _ in model.named_parameters()]
    grads = {k: p.grad.detach().float().cpu().numpy().copy() for k, p in model.named_parameters()}
    before = {k: p.detach().float().cpu().numpy().copy() for k, p in model.named_parameters()}
    metrics = {k: torch.tensor(np.mean([m[k] for m in per_batch])) for k in per_batch[0]}
    metrics = ts.apply_gradient_update(scfg, state, metrics)
    with torch.no_grad():
        metrics.update(ts._variable_metrics(torch.cat(preds), torch.cat(labels), scfg))
    after = dict(model.named_parameters())
    change = {k: after[k].detach().float().cpu().numpy() - before[k] for k in names}
    m = {k: float(v) for k, v in metrics.items() if k not in STEP_METRICS_SKIPPED}
    return step_readings(m, float(metrics["grad_norm"]), grads, change)


def _launch_counters():
    from deepphysinet_tpu_torch.ops import decode_kernel as dk

    return {"decode_primal_v4t": dk.decode_primal_v4t, "fused_decode_jvp_v4s": dk.fused_decode_jvp_v4s,
            "decode_bwd_kernel_v4s": dk.decode_bwd_kernel_v4s}


def port_readings(cfg: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor],
                  inputs: Mapping[str, Any], dtype: torch.dtype,
                  device=None) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """The record's readings of the port at ``dtype`` on ``device`` (``None``: the card; the CPU
    takes the plain versions), R6 in float32 only, and the launches of the primal decode and v4s
    kernels the readings made (each counted from 0)."""
    from deepphysinet_tpu_torch.device import resolve_device
    from deepphysinet_tpu_torch.inference import runner
    from deepphysinet_tpu_torch.physics import engine
    from deepphysinet_tpu_torch.train import train_step as ts

    device = resolve_device(device)
    scfg = ts.step_config_from_cfg(cfg)
    dcfg = runner.decode_config_from_cfg(cfg)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state = port_model(cfg, state_dict, dtype, device)
    model = state.model
    out: Dict[str, np.ndarray] = {}
    nb = inputs["batch"]
    fh_norm = float(nb["forecast_h"][0]) / dcfg.forecast_time_period
    with torch.no_grad():
        # R1: the encode of the inference paths
        tokens = runner._encode(model, torch.from_numpy(nb["field"]).to(device), fh_norm)
        out["tokens"] = tokens.float().cpu().numpy()
        # R2: predict_grid's frame (the conditioning its own, from the same window)
        fr = inputs["frame"]
        grid = runner.predict_grid(model, dcfg, inputs["window"], fr["field"], float(fr["forecast_h"]),
                                   FRAME_HOUR, device=device)
        out["frame"] = np.stack([a.reshape(-1) for a in grid.values()])[:, ::FRAME_STRIDE]
        # R3: the training pair's forward at the collocation points
        fh = torch.tensor([fh_norm], dtype=torch.float32, device=device)
        inter = {k: torch.from_numpy(v[0]).to(device) for k, v in nb["inter"].items()}
        coords = torch.stack([inter["x"], inter["y"], inter["t"]], dim=-1)
        primal, tang = engine.fused_kernel_fields_t(model, tokens, coords, inter["nwp"], fh,
                                                    dcfg.coord_spec, version=7)
        out["v4s_primal"], out["v4s_tangents"] = primal.float().cpu().numpy(), tang.float().cpu().numpy()
        # R4: bench.py's residual evaluation
        rs = {k: torch.from_numpy(v).to(device) for k, v in inputs["residual"].items()}
        losses = engine.fused_residual_losses(model, tokens, rs["coords"], rs["nwp"], fh, rs["f"],
                                              dcfg.coord_spec, dcfg.obs_specs, scfg.factors(),
                                              with_clip=True, version=7)
        out["residual"] = np.array([float(losses[k]) for k in sorted(losses)], np.float64)
    # R5, R6: PDE steps from the seeded state
    for part, v in _port_step(state, cfg, scfg, [nb], device).items():
        out[f"step.{part}"] = v
    if dtype == torch.float32:
        b2 = inputs["batch2"]
        micro = [{k: (v[i : i + 1] if not isinstance(v, Mapping) else {q: w[i : i + 1] for q, w in v.items()})
                  for k, v in b2.items()} for i in range(2)]
        for name, batches in (("b2", [b2]), ("micro", micro)):
            state = port_model(cfg, state_dict, dtype, device)
            for part, v in _port_step(state, cfg, scfg, batches, device).items():
                out[f"{name}.{part}"] = v
    return out, {k: fn.launches for k, fn in counters.items()}


# ---- the record and the comparison -----------------------------------------------------------------


def reading_kind(name: str) -> str:
    return KINDS[name.split(".")[-1]]


def reading_errors(name: str, got: np.ndarray, want: np.ndarray,
                   norms: Optional[np.ndarray] = None, sizes: Optional[np.ndarray] = None,
                   trim: bool = True) -> np.ndarray:
    """The error of each item of reading ``name`` (see KINDS); ``norms`` and ``sizes`` (each
    parameter's JAX norm and entries) scale the probes; ``trim=False`` keeps a "rows" reading's
    outlying points."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"{name}: shape {got.shape}, the record's {want.shape}")
    kind = reading_kind(name)
    d = np.abs(got - want)
    if kind == "array":
        return np.array([d.max() / max(np.abs(want).max(), 1e-30)])
    if kind == "rows":
        d, w = d.reshape(-1, d.shape[-1]), np.abs(want).reshape(-1, want.shape[-1])
        k = int(OUTLIER_SHARE * d.shape[1]) if trim else 0
        return np.sort(d, axis=1)[:, d.shape[1] - 1 - k] / np.maximum(w.max(axis=1), 1e-30)
    if kind == "scalars":
        return d / np.maximum(np.abs(want), 1e-30)
    scale = np.asarray(norms, np.float64) / np.sqrt(np.asarray(sizes, np.float64))
    return d.max(axis=1) / np.maximum(scale, 1e-30)


def item_errors(name: str, got: np.ndarray, want: np.ndarray, meta: Mapping[str, Any],
                norms_from: Mapping[str, np.ndarray], trim: bool = True) -> np.ndarray:
    """``reading_errors`` of reading ``name``, a probe reading scaled by the norms of the same step
    in ``norms_from`` (``PREFIX.leaf_norms`` for gradient probes, ``PREFIX.step_norms`` for update
    probes)."""
    norms = sizes = None
    if reading_kind(name) == "probes":
        prefix, part = name.rsplit(".", 1)
        norms = norms_from[f"{prefix}.{'leaf_norms' if part == 'grad_probes' else 'step_norms'}"]
        sizes = np.asarray(meta["parameter_sizes"])
    return reading_errors(name, got, want, norms, sizes, trim)


def item_names(name: str, meta: Mapping[str, Any], n: int) -> List[str]:
    part = name.split(".")[-1]
    if part in ("leaf_norms", "grad_probes", "step_norms", "step_probes"):
        return list(meta["parameters"])
    if part == "metrics":
        return list(meta["metrics"])
    if part == "residual":
        return list(meta["residual_terms"])
    if part in ("frame", "v4s_primal"):
        return list(meta["variables"])
    if part == "v4s_tangents":
        return [f"d{a} {v}" for a in ("x", "y", "t") for v in meta["variables"]]
    return [name] if n == 1 else [str(i) for i in range(n)]


def load_record(path: str = RECORD) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, arrays) of the record."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    return meta, arrays


def save_record(path: str, meta: Mapping[str, Any], arrays: Mapping[str, np.ndarray]) -> None:
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)),
                        **{k: np.asarray(v) for k, v in arrays.items()})


def checksum_mismatches(meta: Mapping[str, Any], sums: Mapping[str, str]) -> List[str]:
    """The names whose checksum differs from the record's, or that only one side has."""
    want = meta["checksums"]
    return sorted(k for k in set(want) | set(sums) if want.get(k) != sums.get(k))


def noise_items(meta: Mapping[str, Any]) -> np.ndarray:
    """Which parameters hold rounding noise only (NOISE_PARAMETERS), in the record's order."""
    return np.array([any(n.endswith(p) for p in NOISE_PARAMETERS) for n in meta["parameters"]])


def reading_bar(name: str, dtype: str, record: Mapping[str, np.ndarray], sizes: np.ndarray) -> np.ndarray:
    """The bar of each item of reading ``name``: the larger of its floor and SPREAD_TIMES times its
    JAX spread; for "step_probes" at least the Adam flips that the gradient's bar allows."""
    part = name.split(".")[-1]
    spread = record[f"spread/{dtype}/{name}"]
    bar = np.maximum(FLOORS[dtype][part], SPREAD_TIMES * spread)
    if part == "step_probes":
        bar = np.maximum(bar, flip_bar(reading_bar(name[: -len("step_probes")] + "grad_probes", dtype, record,
                                                   sizes), dtype, sizes))
    return bar


def flip_bar(grad_bar: np.ndarray, dtype: str, sizes: np.ndarray) -> np.ndarray:
    """What Adam's sign flips may move an update probe by, for gradients held to ``grad_bar``."""
    share = np.maximum(np.maximum(FLIP_SHARE[dtype], FLIP_PER_GRAD * grad_bar), 1.0 / np.asarray(sizes, np.float64))
    return 4.0 * np.sqrt(np.minimum(share, 1.0))


def held_items(name: str, meta: Mapping[str, Any], spread: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(held, undetermined) masks of reading ``name``'s items: a NOISE_PARAMETERS parameter's
    gradient and update readings are neither; of the rest, those UNDETERMINED by JAX's own forms
    are reported, the others held to their bar."""
    determined = np.asarray(spread) < UNDETERMINED
    noise = np.zeros(determined.shape, bool)
    if name.split(".")[-1] in ("leaf_norms", "grad_probes", "step_norms", "step_probes"):
        noise = noise_items(meta)
    return determined & ~noise, ~determined & ~noise


def compare(readings: Mapping[str, np.ndarray], meta: Mapping[str, Any],
            record: Mapping[str, np.ndarray], dtype: str) -> List[Dict[str, Any]]:
    """One row a reading of ``readings`` (port, ``dtype``) against the record's: its largest
    error / bar ratio among the held items, that item's error, bar and name, the JAX spread there,
    the undetermined items' largest error, and ``ok``; a row ``PREFIX.noise`` a step for the
    NOISE_PARAMETERS' gradient norms over the global norm, in the port and in the record, against
    ZERO_GRAD_NOISE."""
    rows = []
    sizes = np.asarray(meta["parameter_sizes"])
    noise = noise_items(meta)
    jax = {k.split("/", 1)[1]: v for k, v in record.items() if k.startswith(dtype + "/")}
    for name in sorted(readings):
        want = jax[name]
        err = item_errors(name, readings[name], want, meta, jax)
        spread = record[f"spread/{dtype}/{name}"]
        bar = np.broadcast_to(reading_bar(name, dtype, record, sizes), err.shape)
        held, undetermined = held_items(name, meta, spread)
        names = item_names(name, meta, err.size)
        ok = bool(np.all(err[held] <= bar[held]))
        extra = ""
        if reading_kind(name) == "rows":
            worst = item_errors(name, readings[name], want, meta, jax, trim=False)
            cap = np.maximum(OUTLIER_CAP, bar)
            j = int(np.argmax(worst / cap))
            ok = ok and bool(np.all(worst <= cap))
            extra = f"; with its outlying points {worst[j]:.3e} (cap {cap[j]:.3e})"
        if np.any(undetermined):
            j = int(np.argmax(np.where(undetermined, err, -1.0)))
            extra += (f"; {int(undetermined.sum())} undetermined (JAX spread >= {UNDETERMINED}), the largest "
                      f"error there {err[j]:.3e} at {names[j]} (spread {spread[j]:.3e})")
        ratio = np.where(held, err / bar, 0.0)
        i = int(np.argmax(ratio))
        rows.append(dict(reading=name, dtype=dtype, err=float(err[i]), bar=float(bar[i]), spread=float(spread[i]),
                         ratio=float(ratio[i]), item=names[i], items=int(held.sum()), ok=ok, extra=extra))
        if name.endswith(".leaf_norms"):
            prefix = name.rsplit(".", 1)[0]
            share = (readings[name][noise].max() / readings[f"{prefix}.grad_norm"][0],
                     want[noise].max() / jax[f"{prefix}.grad_norm"][0])
            rows.append(dict(reading=f"{prefix}.noise", dtype=dtype, err=float(share[0]), bar=ZERO_GRAD_NOISE,
                             spread=float(share[1]), ratio=float(share[0] / ZERO_GRAD_NOISE),
                             item="key-projection biases over the gradient norm (record's in the spread column)",
                             items=int(noise.sum()), ok=bool(max(share) <= ZERO_GRAD_NOISE), extra=""))
    return rows


def difference_errors(readings: Mapping[str, np.ndarray], meta: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """What the B = 2 step's readings (``b2.PART``) part from the two micro-batches' (``micro.PART``)
    by, item by item, the probes scaled by the B = 2 norms (R6)."""
    return {part: item_errors(f"b2.{part}", readings[f"b2.{part}"], readings[f"micro.{part}"], meta, readings)
            for part in STEP_PARTS}


def b2_micro_rows(readings: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                  record: Mapping[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Phase 24 (b)'s question in float32: what the port's B = 2 step parts from its two
    micro-batches by, each step reading against the bar of what JAX's parted by (the larger of the
    reading's floor and SPREAD_TIMES times JAX's own difference), the held items as ``compare``'s."""
    own = difference_errors(readings, meta)
    rows, grad_bar = [], None
    for part in STEP_PARTS:
        jax_own = record[f"jax_b2_vs_micro/{part}"]
        bar = np.maximum(FLOORS["float32"][part], SPREAD_TIMES * jax_own)
        if part == "grad_probes":
            grad_bar = bar
        if part == "step_probes":
            bar = np.maximum(bar, flip_bar(grad_bar, "float32", meta["parameter_sizes"]))
        held, _ = held_items(f"b2.{part}", meta, record[f"spread/float32/b2.{part}"])
        ratio = np.where(held, own[part] / bar, 0.0)
        i = int(np.argmax(ratio))
        rows.append(dict(reading=f"b2 - micro {part}", dtype="float32", err=float(own[part][i]),
                         bar=float(bar[i]), spread=float(jax_own[i]), ratio=float(ratio[i]),
                         item=item_names(f"b2.{part}", meta, own[part].size)[i], items=int(held.sum()),
                         ok=bool(np.all(own[part][held] <= bar[held])),
                         extra=f"; JAX's own largest {jax_own[held].max():.3e}"))
    return rows


def format_rows(rows: List[Dict[str, Any]]) -> List[str]:
    return [f"{r['dtype']:8s} {r['reading']:18s} err {r['err']:.3e} bar {r['bar']:.3e} "
            f"(JAX spread {r['spread']:.3e}) at {r['item']} of {r['items']}{r['extra']} -> "
            f"{'ok' if r['ok'] else 'FAIL'}" for r in rows]
