"""PyTorch port (deepphysinet_tpu_torch) against the JAX package: checkpoints and inference from disk.

On the smoke configuration's synthetic tree and one JAX checkpoint (flax parameters and a real
optax optimizer state, written by ``deepphysinet_tpu.train.checkpoint.save_model``), the JAX
``run_inference`` and the port's ``run_inference(cfg, checkpoint_path=..., device="cpu")`` sweep the
same hours and export the same files.  The port's own checkpoints round-trip, load into the JAX
package, fall back past a corrupt ``latest`` and save off the caller's thread; the JAX pickles load
without jax, flax or optax; the command line runs inference with ``--set`` overrides, and its test
mode on the JAX checkpoint.
"""

import datetime
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.config import Config

from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data import geotiff as tgt
from deepphysinet_tpu_torch.inference import runner as trunner
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.train import checkpoint as tck
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_slice.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_cfg(root):
    old = os.environ.get("DPN_SMOKE_DATA")
    os.environ["DPN_SMOKE_DATA"] = root
    try:
        return Config.fromfile(os.path.join(REPO, "configs", "smoke_cpu_cfg.py"))["config"]
    finally:
        if old is None:
            del os.environ["DPN_SMOKE_DATA"]
        else:
            os.environ["DPN_SMOKE_DATA"] = old


def _tol(cfg):
    """float32 decode differences of 2e-5 normalized units, in physical units (as
    test_torch_port_slice.py::_tol), in the runner's variable order."""
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER

    return np.array([float(cfg["obs_norm_cfg"][k]["norm_factor"][1]) for k in OBS_NAME_ORDER]) * 2e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The smoke configuration and tree, the JAX interface, and a JAX checkpoint of seeded weights
    with an optax Adam state and the inference metadata."""
    from deepphysinet_tpu.interface.build import builder_models
    from deepphysinet_tpu.train import checkpoint as jck
    from deepphysinet_tpu.train.optim import build_optimizer

    root = str(tmp_path_factory.mktemp("inference_tree"))
    cfg = _smoke_cfg(root)
    iface = builder_models(**cfg)
    rng = np.random.RandomState(2)
    field = rng.randn(1, 159, 170).astype(np.float32)
    params = iface.physics_net.init(jax.random.PRNGKey(6), jnp.asarray(field), jnp.zeros((2, 192)),
                                    jnp.zeros((2, 6)), jnp.asarray([[0.1]], jnp.float32))
    opt_state = build_optimizer(**cfg["train_cfg"]["optimizer"]).init(params)
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    meta = dict(dx=27000.0, dy=27000.0, pred_t_span=86400.0, obs_norm_cfg=cfg["obs_norm_cfg"])
    jck.save_model(ckpt_dir, 4, 40, params, opt_state, **meta)
    return types.SimpleNamespace(root=root, cfg=cfg, iface=iface, params=params, ckpt_dir=ckpt_dir, meta=meta,
                                 tmp=tmp_path_factory)


def _port_model(cfg, sd=None):
    model = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], device="cpu")
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model


def test_run_inference_matches_jax(world):
    """The same hours, grids within ``_tol``, the same exported files (tiffs and jpgs); the tiffs
    carry equal geo-transforms and north-up arrays that agree within that tolerance."""
    from deepphysinet_tpu.inference.runner import run_inference

    cfg_j = _smoke_cfg(world.root)
    cfg_t = _smoke_cfg(world.root)
    out_j, out_t = str(world.tmp.mktemp("out_jax")), str(world.tmp.mktemp("out_port"))
    cfg_j["inference_cfg"]["log"]["vis_path"] = out_j
    cfg_t["inference_cfg"]["log"]["vis_path"] = out_t
    world.iface.inference_cfg = cfg_j["inference_cfg"]
    want = run_inference(world.iface, checkpoint_path=world.ckpt_dir)
    got = trunner.run_inference(cfg_t, checkpoint_path=world.ckpt_dir, device="cpu")
    assert [h for h, _ in got] == [h for h, _ in want] and len(got) == 3
    tol = _tol(cfg_t)
    for (_, g), (_, w) in zip(got, want):
        for i, k in enumerate(("u", "v", "P", "T", "q", "rio")):
            assert g[k].shape == w[k].shape == (37, 65) and g[k].dtype == np.float32
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=tol[i], err_msg=k)
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j)) and len(names) == 3 * 2 * 2  # hours x (T, U) x (tiff, jpg)
    for name in names:
        if name.endswith(".tiff"):
            (a, ga), (b, gb) = tgt.read_tiff(os.path.join(out_t, name)), tgt.read_tiff(os.path.join(out_j, name))
            assert ga == gb and ga[0] == 72.0 and ga[3] == 27.0 and ga[5] == -0.25
            i = 3 if name.endswith("_T.tiff") else 0
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=tol[i])
    # north-up: the first row of the export is the grid's last (northernmost) row
    first = got[0][1]["T"]
    a, _ = tgt.read_tiff(os.path.join(out_t, f"{got[0][0].strftime('%Y-%m-%d_%H_%M_%S')}_T.tiff"))
    np.testing.assert_array_equal(a[:, :, 0], first[::-1])


def test_jax_checkpoint_loads_without_jax(world):
    """A JAX pickle (flax parameters, optax state) loads with jax, flax, optax and the JAX package
    blocked, into the port's names, with optax's classes as named stand-ins."""
    code = f"""
import json, sys
for m in ("jax", "jaxlib", "flax", "optax", "deepphysinet_tpu"):
    sys.modules[m] = None
from deepphysinet_tpu_torch.train import checkpoint as c
payload, epoch, step = c.load_checkpoint({world.ckpt_dir!r})
adam = c.find_jax_objects(payload["opt_state"], "ScaleByAdamState")
sums = {{k: float(v.double().sum()) for k, v in payload["model"].items()}}
print(json.dumps(dict(epoch=epoch, step=step, sums=sums, dx=payload["dx"], adam=len(adam),
                      adam_name=adam[0].name, mu_leaves=len(adam[0][1]["params"]),
                      loaded=sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "optax")
                                    and sys.modules[k] is not None))))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert (out["epoch"], out["step"], out["dx"], out["adam"], out["loaded"]) == (5, 40, 27000.0, 1, [])
    assert out["adam_name"] == "optax._src.transform.ScaleByAdamState" and out["mu_leaves"] == 2
    want = {k: float(v.double().sum()) for k, v in state_dict_from_jax(world.params).items()}
    assert out["sums"] == pytest.approx(want, rel=1e-12, abs=1e-12)
    _port_model(world.cfg, state_dict_from_jax(world.params))  # the names and shapes load strictly


def test_port_checkpoint_round_trips_and_loads_into_jax(world, tmp_path):
    """save_checkpoint writes the reference layout; load_checkpoint reads it back; the weights load into
    the JAX package through convert_torch_state_dict and both forwards agree."""
    from deepphysinet_tpu.inference.runner import predict_points as jpredict_points
    from deepphysinet_tpu.train.torch_import import convert_torch_state_dict
    from deepphysinet_tpu.data.dataset import PhysicsDataset
    from deepphysinet_tpu_torch.data.window import Window

    cfg = world.cfg
    model = _port_model(cfg, state_dict_from_jax(world.params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sum(p.square().sum() for p in model.parameters()).backward()
    opt.step()
    path = tck.save_checkpoint(str(tmp_path), 2, 7, model, opt, **world.meta)
    assert os.path.basename(path) == "physics_2.pth"
    bundle = torch.load(os.path.join(tmp_path, "physics_latest.pth"), weights_only=True)
    assert {"model", "epoch", "gobal_step", "optimizer", "dx", "obs_norm_cfg"} <= set(bundle)
    payload, epoch, step = tck.load_checkpoint(str(tmp_path))
    assert (epoch, step, payload["dx"], payload["obs_norm_cfg"]) == (3, 7, 27000.0, cfg["obs_norm_cfg"])
    for k, v in model.state_dict().items():
        assert torch.equal(payload["model"][k], v), k
    opt2 = torch.optim.Adam(_port_model(cfg, payload["model"]).parameters(), lr=1e-3)
    opt2.load_state_dict(payload["optimizer"])
    assert all(torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in zip(opt.state.values(), opt2.state.values()))
    assert tck.load_checkpoint(str(tmp_path), current_epoch=2)[1:] == (3, 7)

    jparams = convert_torch_state_dict({k: v.numpy() for k, v in payload["model"].items()})
    ds = PhysicsDataset(**cfg["train_cfg"]["train_data"], input_variable_cfg=cfg["variable_cfg"],
                        out_variable_cfg=cfg["obs_norm_cfg"], dx=27000.0, dy=27000.0)
    world.iface.dx = world.iface.dy = 27000.0
    jcfg = world.iface._step_cfg(86400.0, ds.forecast_time_period)
    f = ds.input_files[0]
    window = Window.from_dataset(ds, f, labels=False)
    lon, lat, t = np.array([75.37, 80.1, 86.9]), np.array([19.6, 23.4, 26.2]), np.array([2.5, 13.75, 21.1])
    want = jpredict_points(world.iface.physics_net, jparams, jcfg, ds, f, jnp.asarray(window.field[None]), 6.0,
                           lon, lat, t)
    got = trunner.predict_points(_port_model(cfg, payload["model"]), trunner.decode_config_from_cfg(cfg), window,
                                 window.field[None], 6.0, lon, lat, t, device="cpu")
    err = np.abs(got - want) - (1e-5 * np.abs(want) + _tol(cfg)[None, :])
    assert err.max() <= 0, np.abs(got - want).max(axis=0)


def test_corrupt_latest_falls_back_to_newest_epoch(world, tmp_path):
    cfg = world.cfg
    models = {}
    for epoch in (1, 3, 2):
        models[epoch] = _port_model(cfg, {k: v + epoch for k, v in state_dict_from_jax(world.params).items()})
        tck.save_checkpoint(str(tmp_path), epoch, 10 * epoch, models[epoch])
    with open(tmp_path / "physics_latest.pth", "wb") as fp:
        fp.write(b"PK\x03\x04 truncated")
    payload, epoch, step = tck.load_checkpoint(str(tmp_path))
    assert (epoch, step) == (4, 30)
    assert all(torch.equal(payload["model"][k], v) for k, v in models[3].state_dict().items())
    assert tck.load_checkpoint(str(tmp_path / "missing"))[0] is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]  # every write was moved into place


def test_async_checkpointer_writes_the_snapshot(world, tmp_path):
    """The saved tensors are the ones at submit, whatever the caller does to the model after."""
    model = _port_model(world.cfg, state_dict_from_jax(world.params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt = tck.AsyncCheckpointer()
    ckpt.submit(str(tmp_path), 0, 1, model, None, **world.meta)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ckpt.submit(str(tmp_path), 1, 2, model, None)
    ckpt.close()
    first = tck.load_checkpoint(str(tmp_path), current_epoch=0)[0]["model"]
    assert all(torch.equal(first[k], v) for k, v in before.items())
    assert tck.load_checkpoint(str(tmp_path))[1:] == (2, 2)


def test_cli_runs_inference_with_overrides(world, tmp_path, monkeypatch):
    monkeypatch.setenv("DPN_SMOKE_DATA", world.root)  # the configuration's tree, already written
    args = ["--config_file", os.path.join(REPO, "configs", "smoke_cpu_cfg.py"), "--mode", "inference",
            "--device", "cpu", "--checkpoints_path", world.ckpt_dir,
            "--set", f"inference_cfg.log.vis_path={tmp_path}", "--set", "inference_cfg.log.with_vis=False",
            "--set", "inference_cfg.end_time=2008-01-01_02_00_00", "--set", "inference_cfg.log.export_variable=['q']",
            "--set", "inference_cfg.log.time_offset_hours=6"]
    results = cli.main(args)
    assert [h for h, _ in results] == [datetime.datetime(2008, 1, 1, h) for h in (1, 2)]
    assert sorted(os.listdir(tmp_path)) == ["2008-01-01_07_00_00_q.tiff", "2008-01-01_08_00_00_q.tiff"]
    with pytest.raises(SystemExit, match="not a dict"):
        cli.main(args + ["--set", "inference_cfg.start_time.hour=3"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # --dist runs on the card, or says so
        cli.main(["--config_file", os.path.join(REPO, "configs", "smoke_cpu_cfg.py"), "--mode", "train", "--dist"])
    metrics = cli.main(["--config_file", os.path.join(REPO, "configs", "smoke_cpu_cfg.py"), "--mode", "test",
                        "--device", "cpu", "--checkpoints_path", world.ckpt_dir])
    assert (metrics["epoch"], metrics["global_step"], metrics["full_grid"]) == (4.0, 40.0, 1.0)
    assert all(np.isfinite(metrics[f"rmse_{k}"]) for k in ("u10", "v10", "pres", "t2", "q2", "rio"))
