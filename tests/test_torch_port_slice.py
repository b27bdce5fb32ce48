"""PyTorch port (deepphysinet_tpu_torch) against the JAX package: the inference slice.

``collapsed_decode_t``, ``predict_grid`` and ``predict_points`` run in both
packages on the same weights (JAX init, exported with ``state_dict_from_jax``)
and the same window of the smoke configuration's synthetic data tree: the JAX
``PhysicsDataset`` reads it and the port's ``Window`` takes its arrays.  A
subprocess with ``jax`` and ``flax`` blocked proves that the port imports and
runs without them, as it must on the GPU machine.
"""

import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.config import Config
from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.physics import engine as jengine

from deepphysinet_tpu_torch.data.window import Window, synthetic_window
from deepphysinet_tpu_torch.inference import runner as trunner
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.physics.engine import collapsed_decode_t
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD = dict(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collapsed_decode_t_matches_jax(dtype):
    """Port engine (plain decode on CPU) == JAX engine, XLA twin and Pallas kernel."""
    rng = np.random.RandomState(3)
    meta = dict(enc_in=65, c_out=64, d_model=64, n_heads=4, e_layers=1, d_ff=64,
                activation="gelu", learnable_token_num=8)
    net = dict(in_channels=192, hidden_channels=64, learnable_token_num=16)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JaxPhysicsNet(meta_cfg=meta, net_cfg=net, compute_dtype=jd)
    field = rng.randn(1, 12, 65).astype(np.float32)
    fh = np.array([[0.1]], np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(field), jnp.ones((4, 192)),
                     jnp.ones((4, 6)), jnp.asarray(fh))
    tokens = jm.apply(params, jnp.asarray(field), jnp.asarray(fh), method=JaxPhysicsNet.encode)[0]

    n = 200
    coords = np.stack([rng.rand(n) * 27000 * 256, rng.rand(n) * 27000 * 144,
                       rng.randint(0, 25, n) * 3600.0], -1).astype(np.float32)
    coord_data = (rng.randn(n, 6) * 0.1).astype(np.float32)
    args = (jnp.asarray(coords), jnp.asarray(coord_data), jnp.asarray(fh[0]), JaxCoordSpec(**COORD))
    want_x = jengine.collapsed_decode_t(jm, params, tokens, *args)
    want_k = jengine.collapsed_decode_t(jm, params, tokens, *args, use_kernel=True, interpret=True)

    model = PhysicsNet(meta, net, compute_dtype=td, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    got = collapsed_decode_t(model, torch.from_numpy(np.array(tokens, np.float32)).to(td),
                             torch.from_numpy(coords), torch.from_numpy(coord_data),
                             torch.from_numpy(fh[0]), CoordSpec(**COORD))
    assert tuple(got.shape) == (6, n) and got.dtype == torch.float32
    # f32: the bar of test_decode_kernel_v4t.py.  bf16: the PE inputs are
    # bf16, so an ulp-level sin/cos difference between XLA and torch can flip
    # a rounding (2^-8 of one of 192 terms); measured max |diff| 3.2e-5 at
    # |out| ~ 32
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **tol)


# ---- the slice on the smoke configuration's synthetic tree ------------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """JAX interface + dataset on a fresh synthetic tree, the port twin, and one window."""
    from deepphysinet_tpu.data.dataset import PhysicsDataset
    from deepphysinet_tpu.interface.build import builder_models

    old = os.environ.get("DPN_SMOKE_DATA")
    os.environ["DPN_SMOKE_DATA"] = str(tmp_path_factory.mktemp("port_smoke"))
    try:
        cfg = Config.fromfile(os.path.join(REPO, "configs", "smoke_cpu_cfg.py"))["config"]
    finally:
        if old is None:
            del os.environ["DPN_SMOKE_DATA"]
        else:
            os.environ["DPN_SMOKE_DATA"] = old
    iface = builder_models(**cfg)
    iface.dx = iface.dy = float(cfg["train_cfg"]["dx"])
    ds = PhysicsDataset(**cfg["train_cfg"]["train_data"], input_variable_cfg=iface.variable_cfg,
                        out_variable_cfg=iface.obs_norm_cfg, dx=iface.dx, dy=iface.dy)
    jcfg = iface._step_cfg(86400.0, ds.forecast_time_period)
    input_file = ds.input_files[0]
    window = Window.from_dataset(ds, input_file)
    params = iface.physics_net.init(
        jax.random.PRNGKey(4), jnp.asarray(window.field[None]), jnp.zeros((2, 192)),
        jnp.zeros((2, 6)), jnp.asarray([[0.1]], jnp.float32))
    model = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return types.SimpleNamespace(cfg=cfg, iface=iface, ds=ds, jcfg=jcfg, input_file=input_file,
                                 window=window, params=params, model=model,
                                 tcfg=trunner.decode_config_from_cfg(cfg))


def test_decode_config_matches_jax_step_config(smoke):
    import dataclasses

    t, j = smoke.tcfg, smoke.jcfg
    assert dataclasses.astuple(t.coord_spec) == dataclasses.astuple(j.coord_spec)
    assert t.forecast_time_period == j.forecast_time_period
    assert [dataclasses.astuple(s) for s in t.obs_specs] == [dataclasses.astuple(s) for s in j.obs_specs]


def test_window_matches_dataset(smoke):
    ds, w, f = smoke.ds, smoke.window, smoke.input_file
    np.testing.assert_array_equal(w.field, np.concatenate([ds.get_item_input(f), ds.constant_variables]))
    assert (w.begin_lon, w.begin_lat, w.fine_lon_step, w.fine_lat_step) == (
        ds.begin_lon, ds.begin_lat, ds.fine_lon_step, ds.fine_lat_step)
    rng = np.random.RandomState(5)
    lon = ds.begin_lon + rng.rand(300) * 16.5 - 0.2  # a few points off the grid's edge
    lat = ds.begin_lat + rng.rand(300) * 9.3 - 0.1
    t = rng.rand(300) * 24.0
    np.testing.assert_allclose(w.interp_cube_at(lon, lat, t), ds._interp_cube_at(ds._nwp_cube(f), lon, lat, t),
                               rtol=1e-6, atol=1e-6)
    xs, ys = np.meshgrid(np.arange(5.0), np.arange(3.0))
    tl = np.full(xs.size, 7.5)
    for a, b in zip(w.get_margin_grid(xs.ravel(), ys.ravel(), tl),
                    ds.get_margin_grid(f, xs.ravel(), ys.ravel(), tl)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _tol(cfg):
    """float32 decode differences of 2e-5 normalized units, in physical units."""
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER

    return np.array([float(cfg["obs_norm_cfg"][k]["norm_factor"][1]) for k in OBS_NAME_ORDER]) * 2e-5


@pytest.mark.parametrize("time_h, out_size", [(3.0, None), (6.5, None), (23.0, (19, 33))])
def test_predict_grid_matches_jax(smoke, time_h, out_size):
    from deepphysinet_tpu.inference.runner import predict_grid

    field = smoke.window.field[None]
    want = predict_grid(smoke.iface.physics_net, smoke.params, smoke.jcfg, smoke.ds, smoke.input_file,
                        jnp.asarray(field), 0.0, time_h, out_size=out_size)
    got = trunner.predict_grid(smoke.model, smoke.tcfg, smoke.window, torch.from_numpy(field), 0.0,
                               time_h, out_size=out_size, device="cpu")
    tol = _tol(smoke.cfg)
    for i, k in enumerate(("u", "v", "P", "T", "q", "rio")):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=tol[i], err_msg=k)


def test_predict_points_matches_jax(smoke):
    from deepphysinet_tpu.inference.runner import predict_points

    field = smoke.window.field[None]
    lon = np.array([75.37, 80.123, 84.9, 72.0])
    lat = np.array([19.61, 23.456, 26.2, 18.0])
    t = np.array([2.5, 13.75, 21.1, 0.0])
    want = predict_points(smoke.iface.physics_net, smoke.params, smoke.jcfg, smoke.ds, smoke.input_file,
                          jnp.asarray(field), 6.0, lon, lat, t)
    got = trunner.predict_points(smoke.model, smoke.tcfg, smoke.window, torch.from_numpy(field), 6.0,
                                 lon, lat, t, device="cpu")
    assert got.shape == (4, 6)
    err = np.abs(got - want) - (1e-5 * np.abs(want) + _tol(smoke.cfg)[None, :])
    assert err.max() <= 0, np.abs(got - want).max(axis=0)


def test_chunked_decode_matches_whole(smoke):
    """Chunking (40,960 points per decode) does not change any point's output."""
    rng = np.random.RandomState(6)
    n = 53
    cs = smoke.tcfg.coord_spec
    x = rng.rand(n).astype(np.float32) * cs.dx * (cs.lon_size - 1)
    y = rng.rand(n).astype(np.float32) * cs.dy * (cs.lat_size - 1)
    t = rng.rand(n).astype(np.float32) * 86400.0
    nwp = (rng.randn(n, 6) * 0.1).astype(np.float32)
    tokens = trunner._encode(smoke.model, torch.from_numpy(smoke.window.field[None]), 0.0)
    whole = trunner._decode_points(smoke.model, smoke.tcfg, tokens, x, y, t, nwp, 0.0, True)
    chunked = trunner._decode_points(smoke.model, smoke.tcfg, tokens, x, y, t, nwp, 0.0, True, chunk=16)
    empty = trunner._decode_points(smoke.model, smoke.tcfg, tokens, x[:0], y[:0], t[:0], nwp[:0], 0.0, True)
    assert tuple(whole.shape) == (6, n) and tuple(empty.shape) == (6, 0)
    diff = np.abs(chunked.numpy() - whole.numpy())
    assert (diff <= 1e-6 * np.abs(whole.numpy()) + _tol(smoke.cfg)[:, None] / 20).all(), diff.max(axis=1)


def test_synthetic_window_flagship_sizes():
    cfg = Config.fromfile(os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py"))["config"]
    w = synthetic_window(cfg, seed=0)
    assert w.field.shape == (159, 2405) and w.field.dtype == np.float32
    assert w.nwp_cube.shape == (6, 37, 65, 5)
    assert (w.in_lon[0], w.in_lon[-1], w.in_lat[-1]) == (72.0, 136.0, 54.0)
    assert (len(w.out_lon), len(w.out_lat), w.fine_lon_step) == (257, 145, 0.25)
    assert 0.0 <= w.field[-4:].min() and w.field[-4:].max() < 1.0
    np.testing.assert_array_equal(synthetic_window(cfg, seed=0).field, w.field)
    assert not np.array_equal(synthetic_window(cfg, seed=1).nwp_cube, w.nwp_cube)


def test_port_never_imports_jax():
    """No port module, and not chip_smoke.py, imports jax, flax or the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "deepphysinet_tpu_torch")):
        files += [os.path.join(d, name) for name in names if name.endswith(".py")]
    assert len(files) > 20
    jax_package = re.compile(r"^\s*(import|from)\s+deepphysinet_tpu(\.|\s|$)", re.M)
    for path in files:
        text = open(path).read()
        for bad in ("import jax", "from jax", "import flax", "from flax", "import optax",
                    "from optax"):
            assert bad not in text, (path, bad)
        assert not jax_package.search(text), path


def test_default_device_raises_without_cuda():
    """No entry point lands on the CPU silently: without a card, ``device=None`` raises."""
    from deepphysinet_tpu_torch.device import default_device, resolve_device
    from deepphysinet_tpu_torch.train.train_step import batch_to_device, create_train_state

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda", 0)
        return
    meta = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32,
                activation="gelu", learnable_token_num=8)
    net = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PhysicsNet(meta, net)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(meta, net, dict(name="Adam"), torch.Generator().manual_seed(0))
    cfg = Config.fromfile(os.path.join(REPO, "configs", "smoke_cpu_cfg.py"))["config"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_to_device(dict(field=np.zeros((1, 2, 3)), forecast_h=np.zeros(1),
                             margin={}, inter={}))
    model = PhysicsNet(meta, net, device="cpu")
    dc = trunner.decode_config_from_cfg(cfg)
    field = np.zeros((1, 12, 65), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trunner.predict_grid(model, dc, None, field, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trunner.predict_points(model, dc, None, field, 0.0, [75.0], [20.0], [1.0])


_POISONED = r"""
import json, pkgutil, sys, importlib
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.modules["deepphysinet_tpu"] = None
import numpy as np, torch
torch.set_num_threads(1)
import deepphysinet_tpu_torch
for m in pkgutil.walk_packages(deepphysinet_tpu_torch.__path__, "deepphysinet_tpu_torch."):
    importlib.import_module(m.name)
from deepphysinet_tpu_torch.config import Config
from deepphysinet_tpu_torch.data.window import synthetic_batch, synthetic_window
from deepphysinet_tpu_torch.eval.residuals import evaluate_residuals
from deepphysinet_tpu_torch.eval.rmse import evaluate_rmse_fullgrid
from deepphysinet_tpu_torch.inference.runner import decode_config_from_cfg, predict_grid, predict_points
from deepphysinet_tpu_torch.train.train_step import (
    batch_to_device, create_train_state, make_train_step, step_config_from_cfg)

cfg = Config.fromfile("configs/DeepPhysiNet_NCEP_cfg.py")["config"]
cfg["train_cfg"]["img_size"] = (37, 65)  # coarse grid 10 x 17 = enc_in 170
cfg["meta_cfg"].update(enc_in=170, c_out=32, d_model=32, n_heads=4, e_layers=2, d_ff=32)
cfg["net_cfg"].update(hidden_channels=32, learnable_token_num=40)
cfg["train_cfg"]["train_data"].update(label_batch_size=48, batch_size_inter=24,
                                       label_time_step=6)  # 5 labelled hours per window
state = create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                           torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
model = state.model
w = synthetic_window(cfg, seed=0)
dc = decode_config_from_cfg(cfg)
grid = predict_grid(model, dc, w, w.field[None], w.forecast_h, 6.5, device="cpu")
pts = predict_points(model, dc, w, w.field[None], w.forecast_h, [75.3, 80.1], [20.2, 25.0],
                     [1.5, 20.0], device="cpu")
# one PDE training step through the 'kernel' engine (its plain versions on the CPU)
before = [p.detach().clone() for p in model.parameters()]
step = make_train_step(step_config_from_cfg(cfg))
batch = batch_to_device(synthetic_batch(cfg, seed=1), device="cpu")
state, metrics = step(state, batch, True)
metrics = {k: float(v) for k, v in metrics.items()}
moved = sum(bool((a != b).any()) for a, b in zip(before, model.parameters()))
# one PDE step with kernel_version=4 (the v4t pair) and the evaluation sweeps (v4t forward,
# primal decode), again through the plain versions
cfg["train_cfg"]["tpu"]["kernel_version"] = 4
scfg4 = step_config_from_cfg(cfg)
state, metrics4 = make_train_step(scfg4)(state, batch, True)
sweeps = dict(evaluate_residuals(model, scfg4, [w], device="cpu"))
sweeps.update(evaluate_rmse_fullgrid(model, scfg4, [w], per_lead=True, device="cpu"))
# one PDE step with kernel_version=6 (the v6 pair) and the in-kernel residual assembly of
# both versions, through the plain versions
cfg["train_cfg"]["tpu"]["kernel_version"] = 6
scfg6 = step_config_from_cfg(cfg)
state, metrics6 = make_train_step(scfg6)(state, batch, True)
from deepphysinet_tpu_torch.ops.residual_kernel import kernel_residual_losses
from deepphysinet_tpu_torch.physics.engine import fused_residual_losses
with torch.no_grad():
    fh = (batch.forecast_h / scfg6.forecast_time_period)[:, None]
    tokens = model.encode(batch.field, fh)[0]
m = batch.margin
args = (model, tokens, torch.stack([m.x[0], m.y[0], m.t[0]], -1), m.nwp[0], fh[0], m.f[0],
        scfg6.coord_spec, scfg6.obs_specs, scfg6.factors())
fused = [kernel_residual_losses(*args, version=v) for v in (4, 6)]
fused.append(fused_residual_losses(*args, version=6))
# one PDE step with kernel_version=2 (FusedDecodeJvpV2, on a copy of the state) and the
# version-2 residual losses; the in_kernel_pe route (v4pe) and direct calls of v3 and v5
import copy
from deepphysinet_tpu_torch.ops import decode_kernel as dk
from deepphysinet_tpu_torch.physics.engine import _kernel_inputs, fused_kernel_fields
cfg["train_cfg"]["tpu"]["kernel_version"] = 2
scfg2 = step_config_from_cfg(cfg)
_, metrics2 = make_train_step(scfg2)(copy.deepcopy(state), batch, True)
losses2 = fused_residual_losses(*args, version=2)
with torch.no_grad():
    outs = [fused_kernel_fields(*args[:5], scfg2.coord_spec, scfg2.obs_specs, version=4, in_kernel_pe=True,
                                raw_tangents=True)]
    weights, pe, dpe, cd_pe = _kernel_inputs(*args[:5], scfg2.coord_spec)
    outs.append(dk.fused_decode_jvp_v3(weights, args[2], args[3], scfg2.coord_spec, torch.bfloat16))
    outs.append(dk.fused_decode_jvp_v5(dk.fuse_decode_weights(weights), pe, dpe, cd_pe, args[3], torch.bfloat16))
v2 = [scfg2.kernel_version, scfg2.pde_engine, all(np.isfinite(float(v)) for v in metrics2.values()),
      len(losses2), all(np.isfinite(float(v)) for v in losses2.values()),
      all(bool(torch.isfinite(x).all()) for pair in outs for x in pair)]
# the encoder's attention kernels (attn_impl) and the fused encoder, through their plain versions
from deepphysinet_tpu_torch.ops.encoder_kernel import encode_fused
encoded = {}
for impl in ("pallas", "flash"):
    twin = create_train_state(cfg["meta_cfg"], cfg["net_cfg"], cfg["train_cfg"]["optimizer"],
                              torch.Generator().manual_seed(0), torch.float32, device="cpu",
                              attn_impl=impl).model
    with torch.no_grad():
        tokens_impl = twin.encode(batch.field, fh)
    encoded[impl] = bool(torch.isfinite(tokens_impl).all())
encoded["fused"] = bool(torch.allclose(encode_fused(twin, batch.field, fh), tokens_impl, atol=1e-4))
# inference from disk through the command line: a port-written GeoTIFF tree and the JAX checkpoint
# that the test wrote (flax parameters, optax state) at these widths, set on the flagship config
import os
from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data.synthetic import generate_synthetic_dataset
from deepphysinet_tpu_torch.train.checkpoint import find_jax_objects, load_checkpoint
work = os.environ["DPN_BLOCKED_WORK"]
paths = generate_synthetic_dataset(os.path.join(work, "tree"), n_init_times=2, bbox=(72.0, 18.0, 88.0, 27.0))
d = "train_cfg.valid_data."
sets = [f"{d}input_path={paths['input_path']}", f"{d}label_path={paths['label_path']}",
        f"{d}constant_path={paths['constant_path']}", f"{d}in_coord_file={paths['in_coord_file']}",
        f"{d}out_coord_file={paths['out_coord_file']}", f"{d}input_data_map_cfg.NCEP={paths['input_map_file']}",
        f"{d}label_img_size=(37, 65)", f"{d}start_time=2008-01-01_00_00_00", f"{d}end_time=2008-01-01_00_00_00",
        "train_cfg.img_size=(37, 65)", "inference_cfg.img_size=(37, 65)",
        "meta_cfg.enc_in=170", "meta_cfg.c_out=32", "meta_cfg.d_model=32", "meta_cfg.e_layers=2",
        "meta_cfg.d_ff=32", "net_cfg.hidden_channels=32", "net_cfg.learnable_token_num=40",
        "inference_cfg.start_time=2008-01-01_05_00_00", "inference_cfg.end_time=2008-01-01_06_00_00",
        "inference_cfg.log.with_vis=False", "inference_cfg.log.write_source=True",
        f"inference_cfg.log.vis_path={os.path.join(work, 'out')}"]
cli_args = ["--config_file", "configs/DeepPhysiNet_NCEP_cfg.py", "--mode", "inference", "--device", "cpu",
            "--checkpoints_path", os.environ["DPN_JAX_CKPT"]]
for item in sets:
    cli_args += ["--set", item]
hours = cli.main(cli_args)
# two training steps from scratch through the command line on the same tree (the second with the
# PDE terms), saved in the port's layout
d = "train_cfg.train_data."
train_sets = [item.replace("train_cfg.valid_data.", d) for item in sets[:9]]
train_sets[-1] = f"{d}end_time=2008-01-02_00_00_00"
train_sets += [f"{p}{k}={v}" for p in (d, "train_cfg.valid_data.") for k, v in
               (("label_batch_size", 48), ("batch_size_inter", 24))]
train_sets += ["train_cfg.num_workers=1", "train_cfg.tpu.pde_start_step=1", "train_cfg.log.with_vis=False"]
train_args = ["--config_file", "configs/DeepPhysiNet_NCEP_cfg.py", "--mode", "train", "--device", "cpu",
              "--max_steps", "2", "--checkpoints_path", os.path.join(work, "trained"),
              "--log_path", os.path.join(work, "log")]
for item in sets[:-5] + train_sets:
    train_args += ["--set", item]
trained = cli.main(train_args)
train = [trained.step, sorted(os.listdir(os.path.join(work, "trained"))),
         all(bool(torch.isfinite(p).all()) for p in trained.model.parameters())]
# two steps with the points sampled on the device, each sampler (the cubes, the draws, the pool)
device = []
for sampler in ("iid", "pool"):
    out_dir = os.path.join(work, f"trained_{sampler}")
    args = [out_dir if a == os.path.join(work, "trained") else a for a in train_args]
    trained = cli.main(args + ["--set", "train_cfg.tpu.sample_mode=device", "--set", f"train_cfg.tpu.ds_sampler={sampler}"])
    device.append([trained.step, sorted(os.listdir(out_dir)),
                   all(bool(torch.isfinite(p).all()) for p in trained.model.parameters())])
# the three tools on the same tree and JAX checkpoint: evaluate's modes (the maps need matplotlib),
# stations (one at a fractional hour, one at every hour of the window) and products beside the model
from deepphysinet_tpu_torch.tools import derive_products, evaluate, infer_stations
tool_args = ["--config_file", "configs/DeepPhysiNet_NCEP_cfg.py", "--device", "cpu"]
for item in sets:
    tool_args += ["--set", item]
jax_ckpt = os.environ["DPN_JAX_CKPT"]
scores = [evaluate.main(tool_args + ["--checkpoint", jax_ckpt] + mode)
          for mode in (["--points_per_window", "128"], ["--full_grid", "--per_lead"],
                       ["--off_lattice", "--points_per_window", "256"], ["--residuals"])]
with open(os.path.join(work, "stations.csv"), "w") as fp:
    fp.write("name,lon,lat,t_hours\nA,75.37,19.61,2.5\nB,80.0,22.0,\n")
rows = infer_stations.main(tool_args + ["--checkpoint", jax_ckpt, "--stations", os.path.join(work, "stations.csv"),
                                        "--out", os.path.join(work, "stations_out.csv")])
summary = derive_products.main(tool_args + ["--split", "valid_data", "--times", "1", "--products", "t2,slp,wd10m",
                                            "--output", os.path.join(work, "products"), "--vs_model", jax_ckpt])
tools = [all(np.isfinite(v) for s in scores for v in s.values() if isinstance(v, float)),
         [s["global_step"] for s in scores], scores[1]["n_points"], scores[2]["n_points"], len(rows),
         all(np.isfinite(float(r[k])) for r in rows for k in ("u10", "t2", "rho")), summary["written"],
         sorted(summary["vs_model"]["pairs"])]
payload = load_checkpoint(os.environ["DPN_JAX_CKPT"])[0]
disk = [len(hours), sorted(os.listdir(os.path.join(work, "out"))),
        all(bool(np.isfinite(g["T"]).all()) for _, g in hours),
        len(find_jax_objects(payload["opt_state"], "ScaleByAdamState"))]
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "jaxlib", "optax",
                "deepphysinet_tpu") and sys.modules[k] is not None)
print(json.dumps({"loaded": loaded, "T": list(grid["T"].shape), "pts": list(pts.shape),
                  "finite": bool(np.isfinite(grid["T"]).all() and np.isfinite(pts).all()),
                  "metrics_finite": all(np.isfinite(v) for v in metrics.values()),
                  "has_pde": "inter_total" in metrics and "margin_vapor_loss" in metrics,
                  "skipped": metrics["skipped_nonfinite"], "step": state.step,
                  "all_moved": moved == len(before), "kernel_version": scfg4.kernel_version,
                  "v4_finite": all(np.isfinite(float(v)) for v in metrics4.values()),
                  "v6": [scfg6.kernel_version, all(np.isfinite(float(v)) for v in metrics6.values()), state.step],
                  "fused_keys": sorted(len(d) for d in fused),
                  "fused_finite": all(np.isfinite(float(v)) for d in fused for v in d.values()),
                  "sweeps_finite": all(np.isfinite(v) for v in sweeps.values()),
                  "sweep_hours": sweeps["n_hours"], "sweep_points": sweeps["n_points"],
                  "has_lead": "rmse_t2_f048" in sweeps and "weighted_total" in sweeps,
                  "encoded": encoded, "v2": v2, "disk": disk, "train": train, "device": device,
                  "tools": tools}))
"""


def _blocked_jax_checkpoint(path):
    """A JAX checkpoint (flax parameters and an optax Adam state, as the JAX trainer saves them) of
    the model that ``_POISONED`` sets on the flagship config, for its inference from disk."""
    from deepphysinet_tpu.train import checkpoint as jck
    from deepphysinet_tpu.train.optim import build_optimizer

    cfg = Config.fromfile(os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py"))["config"]
    cfg["meta_cfg"].update(enc_in=170, c_out=32, d_model=32, e_layers=2, d_ff=32)
    cfg["net_cfg"].update(hidden_channels=32, learnable_token_num=40)
    meta = {k: v for k, v in cfg["meta_cfg"].items() if k != "name"}
    net = {k: v for k, v in cfg["net_cfg"].items() if k != "name"}
    jm = JaxPhysicsNet(meta_cfg=meta, net_cfg=net, compute_dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(9), jnp.zeros((1, 159, 170)), jnp.zeros((2, 192)), jnp.zeros((2, 6)),
                     jnp.asarray([[0.1]], jnp.float32))
    jck.save_model(path, 1, 12, params, build_optimizer("Adam", lr=1e-4, weight_decay=1e-4).init(params),
                   dx=27000.0, dy=27000.0, pred_t_span=86400.0, obs_norm_cfg=cfg["obs_norm_cfg"])


def test_port_runs_with_jax_blocked(tmp_path):
    _blocked_jax_checkpoint(str(tmp_path / "jax_ckpt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, DPN_JAX_CKPT=str(tmp_path / "jax_ckpt"), DPN_BLOCKED_WORK=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", _POISONED], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"loaded": [], "T": [37, 65], "pts": [2, 6], "finite": True,
                   "metrics_finite": True, "has_pde": True, "skipped": 0.0, "step": 3,
                   "all_moved": True, "kernel_version": 4, "v4_finite": True, "sweeps_finite": True,
                   "v6": [6, True, 3], "fused_keys": [7, 7, 7], "fused_finite": True,
                   "sweep_hours": 5.0, "sweep_points": 5.0 * 37 * 65, "has_lead": True,
                   "encoded": {"pallas": True, "flash": True, "fused": True},
                   "v2": [2, "kernel", True, 7, True, True],
                   "disk": [2, ["2008-01-01_11_00_00_T.tiff", "2008-01-01_12_00_00_T.tiff"], True, 1],
                   "train": [2, ["codes.zip", "physics_0.pth", "physics_latest.pth"], True],
                   "device": [[2, ["codes.zip", "physics_0.pth", "physics_latest.pth"], True]] * 2,
                   "tools": [True, [12] * 4, 25.0 * 37 * 65, 256.0, 1 + 25, True, 3, ["t2", "wd10m"]]}
