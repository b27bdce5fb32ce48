"""PyTorch port against the JAX package: the command-line tools and the trainer's renders.

On the smoke configuration's values (``configs/smoke_cpu_cfg.py``) at tiny widths
(``tests/test_train_step.py``), a tree that the port's generator wrote, seeded datasets and one JAX
checkpoint, each port tool (``deepphysinet_tpu_torch/tools/``) and the JAX tool it stands for
(``tools/``) run in process on the same configuration file, and their outputs are held to each
other:

* ``evaluate`` in its four modes (subsampled, ``--full_grid --per_lead``, ``--off_lattice`` and
  ``--residuals --save_maps``): every printed metric, at the tolerances of the sweeps' own tests
  (RMSE rtol 2e-4 and the bias to 2e-4 of its RMSE, ``test_torch_port_eval.py``; residual MSEs rtol
  2e-3), beside the 6-decimal rounding of the printed line (1e-6);
* ``infer_stations`` on a CSV of on- and off-grid stations, one with a fractional hour and one
  without hours: the same rows, their values within ``test_torch_port_slice.py``'s point bound
  (1e-5 relative plus float32 decode differences of 2e-5 normalized units);
* ``derive_products --vs_model --vis``: the same files, every GeoTIFF array for array (numpy in
  both), the products' statistics bit for bit and the model's within the point bound.

Also: the port's copy of ``configs/synthetic_fullscale_cfg.py`` key for key against it, and the
trainer's ``_render_grid`` (``with_vis``) in a two-step run of both trainers, its grids against the
JAX trainer's.
"""

import contextlib
import copy
import csv
import io
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.interface import interface_physics as jip
from deepphysinet_tpu.interface.build import builder_models as j_builder_models
from deepphysinet_tpu.train import checkpoint as jck
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer

from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree
from deepphysinet_tpu_torch.interface import interface_physics as tip
from deepphysinet_tpu_torch.interface.build import builder_models
from deepphysinet_tpu_torch.tools import derive_products as t_derive
from deepphysinet_tpu_torch.tools import evaluate as t_evaluate
from deepphysinet_tpu_torch.tools import infer_stations as t_stations
from tests.test_torch_port_trainer import SMOKE_TREE, _seeded_by_window, _smoke_cfg, _tol
from tools import derive_products as j_derive
from tools import evaluate as j_evaluate
from tools import infer_stations as j_stations

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_eval.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSE_RTOL = 2e-4
RESIDUAL_RTOL = 2e-3
PRINTED = 1e-6  # the printed line rounds to 6 decimals
STATIONS = "name,lon,lat,t_hours\nA,75.37,19.61,\nB,80.0,22.0,3.5\nC,72.0,18.0,24\nD,87.9,26.93,0.25\n"


def _run_jax_tool(module, argv):
    """A JAX tool's ``main()`` in process on ``argv``; returns what it printed."""
    old, sys.argv = sys.argv, [module.__file__] + list(argv)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def _run_port_tool(module, argv):
    """A port tool's ``main(argv)`` on the CPU; returns (its result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(list(argv) + ["--device", "cpu"])
    return out, buf.getvalue()


def _last_json(text):
    import json

    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The smoke tree, the configuration file both packages' tools read (tiny widths, seeded
    datasets), and a JAX checkpoint of seeded weights at step 7."""
    root = str(tmp_path_factory.mktemp("tools_tree"))
    ensure_synthetic_tree(root, **SMOKE_TREE)
    cfg = _smoke_cfg(root)
    cfg["meta_cfg"].update(c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32, learnable_token_num=8)
    cfg["net_cfg"].update(hidden_channels=32, learnable_token_num=16)
    work = str(tmp_path_factory.mktemp("tools_work"))
    cfg["train_cfg"]["checkpoints"]["checkpoints_path"] = os.path.join(work, "ckpt")
    cfg["train_cfg"]["log"]["log_path"] = os.path.join(work, "log")
    iface = j_builder_models(**copy.deepcopy(cfg))
    rng = np.random.RandomState(8)
    params = iface.physics_net.init(jax.random.PRNGKey(3), jnp.asarray(rng.randn(1, 159, 170).astype(np.float32)),
                                    jnp.zeros((2, 192)), jnp.zeros((2, 6)), jnp.asarray([[0.1]], jnp.float32))
    jck.save_checkpoint(os.path.join(work, "ckpt"), 0, 7, params, prefix="physics", dx=27000.0, dy=27000.0)
    cfg_file = os.path.join(work, "tools_cfg.py")
    with open(cfg_file, "w") as fp:
        fp.write(f"config = {cfg!r}\n")
    return types.SimpleNamespace(root=root, cfg=cfg, cfg_file=cfg_file, work=work, params=params,
                                 tol=np.array(list(_tol(cfg).values())), tmp=tmp_path_factory)


EVAL_MODES = {
    "subsampled": ["--points_per_window", "300"],
    "full_grid": ["--full_grid", "--per_lead", "--split", "train_data"],
    "off_lattice": ["--off_lattice", "--points_per_window", "512", "--split", "train_data"],
    "residuals": ["--residuals", "--save_maps", "{maps}", "--map_window", "1", "--map_hour", "3",
                  "--split", "train_data"],
}


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_evaluate_matches_jax_tool(world, mode):
    runs = {}
    for name in ("jax", "port"):
        maps = os.path.join(world.work, f"maps_{name}")
        argv = ["--config_file", world.cfg_file] + [a.format(maps=maps) for a in EVAL_MODES[mode]]
        if name == "jax":
            runs[name] = _last_json(_run_jax_tool(j_evaluate, argv))
        else:
            returned, printed = _run_port_tool(t_evaluate, argv)
            runs[name] = _last_json(printed)
            assert returned["global_step"] == runs[name]["global_step"]
    want, got = runs["jax"], runs["port"]
    assert sorted(got) == sorted(want)
    assert (got["epoch"], got["global_step"]) == (want["epoch"], want["global_step"]) == (0, 7)
    rtol = RESIDUAL_RTOL if mode == "residuals" else RMSE_RTOL
    for k, w in want.items():
        if isinstance(w, str):  # the maps' directory
            continue
        scale = want["rmse_" + k[len("bias_"):]] if k.startswith("bias_") else 0.0
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * scale + PRINTED, err_msg=k)
    if mode == "residuals":
        names = sorted(os.listdir(want["maps_dir"]))
        assert names == sorted(os.listdir(got["maps_dir"])) and len(names) == 6
        assert all(os.path.getsize(os.path.join(got["maps_dir"], n)) > 1000 for n in names)
    if mode == "off_lattice":
        assert got["n_points"] == 2 * 512 and 0.5 < got["ratio_t2"] < 2.0


def test_infer_stations_matches_jax_tool(world):
    stations = os.path.join(world.work, "stations.csv")
    with open(stations, "w") as fp:
        fp.write(STATIONS)
    rows = {}
    for name, module in (("jax", j_stations), ("port", t_stations)):
        out = os.path.join(world.work, f"stations_{name}.csv")
        argv = ["--config_file", world.cfg_file, "--stations", stations, "--out", out, "--split", "train_data",
                "--max_windows", "2"]
        printed = _run_jax_tool(module, argv) if name == "jax" else _run_port_tool(module, argv)[1]
        assert printed.strip().splitlines()[-1] == f"wrote {2 * (25 + 3)} rows to {out}"
        with open(out) as fp:
            rows[name] = list(csv.DictReader(fp))
    assert len(rows["port"]) == len(rows["jax"]) == 2 * (25 + 3)
    keys = ("u10", "v10", "psfc", "t2", "q2", "rho")
    for got, want in zip(rows["port"], rows["jax"]):
        assert list(got) == list(want) == ["station", "window", "lon", "lat", "t_hours", *keys]
        assert [got[k] for k in ("station", "window", "lon", "lat", "t_hours")] == \
               [want[k] for k in ("station", "window", "lon", "lat", "t_hours")]
        g, w = np.array([float(got[k]) for k in keys]), np.array([float(want[k]) for k in keys])
        assert np.isfinite(g).all()
        assert (np.abs(g - w) <= 1e-5 * np.abs(w) + world.tol).all(), (got, want)
    assert {r["window"] for r in rows["port"]} == {"2008-01-01-00-00-00_f000", "2008-01-02-00-00-00_f000"}
    assert [r["t_hours"] for r in rows["port"][:27]] == [str(float(h)) for h in range(25)] + ["3.5", "24.0"]


def test_derive_products_matches_jax_tool(world):
    from deepphysinet_tpu_torch.data.geotiff import read_full_image

    summaries = {}
    for name in ("jax", "port"):
        out = os.path.join(world.work, f"products_{name}")
        argv = ["--config_file", world.cfg_file, "--products", "slp,t2,td2,u10m,rh_p850,wd10m,rh2", "--times", "2",
                "--output", out, "--vs_model", os.path.join(world.work, "ckpt"), "--vis"]
        printed = _run_jax_tool(j_derive, argv) if name == "jax" else _run_port_tool(t_derive, argv)[1]
        summaries[name] = _last_json(printed)
    want, got = summaries["jax"], summaries["port"]
    assert got["written"] == want["written"] == 14 and got["products"] == want["products"]
    files = sorted(os.listdir(want["output"]))
    assert sorted(os.listdir(got["output"])) == files and len(files) == 14 * 2 + 4  # GeoTIFFs, jpgs; 3 + 1 VSMODEL jpgs
    for f in files:
        if f.endswith(".tiff"):
            a = read_full_image(os.path.join(got["output"], f))
            assert np.isfinite(a).all(), f
            np.testing.assert_array_equal(a, read_full_image(os.path.join(want["output"], f)), err_msg=f)
    assert got["vs_model"]["window"] == want["vs_model"]["window"]
    assert sorted(got["vs_model"]["pairs"]) == sorted(want["vs_model"]["pairs"]) == ["t2", "wd10m"]
    t_tol = world.tol[3]  # T's; the wind speed's is below it (u and v: 4 m/s x 2e-5)
    for pair, stats in want["vs_model"]["pairs"].items():
        g = got["vs_model"]["pairs"][pair]
        assert g["product_mean"] == stats["product_mean"], pair
        for k in ("rmse", "bias", "model_mean"):
            np.testing.assert_allclose(g[k], stats[k], rtol=1e-5, atol=t_tol, err_msg=f"{pair} {k}")


def test_tools_need_matplotlib_for_renders(world, monkeypatch):
    """Without matplotlib, ``--save_maps`` and ``--vis`` raise an error that names it before any work."""
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda n, *a: None if n == "matplotlib" else find_spec(n, *a))
    out = os.path.join(world.work, "no_render")
    with pytest.raises(ImportError, match="matplotlib"):
        t_evaluate.main(["--config_file", world.cfg_file, "--device", "cpu", "--residuals", "--save_maps", out])
    with pytest.raises(ImportError, match="matplotlib"):
        t_derive.main(["--config_file", world.cfg_file, "--device", "cpu", "--vis", "--output", out])
    assert not os.path.exists(out)


def test_tools_raise_without_cuda(world):
    """No tool lands on the CPU quietly: without ``--device`` they run on the first CUDA device, and
    without one they raise."""
    if torch.cuda.is_available():
        return
    stations = os.path.join(world.work, "stations_nocuda.csv")
    with open(stations, "w") as fp:
        fp.write(STATIONS)
    base = ["--config_file", world.cfg_file]
    for module, argv in ((t_evaluate, ["--full_grid"]), (t_stations, ["--stations", stations]),
                         (t_derive, ["--vs_model", os.path.join(world.work, "ckpt")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(base + argv)


def test_fullscale_config_copy_matches_jax_config(monkeypatch, tmp_path):
    """The port's ``synthetic_fullscale_cfg.py`` against ``configs/synthetic_fullscale_cfg.py`` key for
    key, each loaded with its package's tree generator patched to a no-op (no full-scale tree is
    written), which each must call alike."""
    import deepphysinet_tpu.data.synthetic as jsynth
    import deepphysinet_tpu_torch.data.synthetic as tsynth
    from deepphysinet_tpu.config import Config as JaxConfig
    from deepphysinet_tpu_torch.config import Config

    calls = {}
    monkeypatch.setenv("DPN_FULLSYNTH_DATA", str(tmp_path / "fullsynth"))
    monkeypatch.setattr(jsynth, "ensure_synthetic_tree", lambda *a, **k: calls.setdefault("jax", (a, k)))
    monkeypatch.setattr(tsynth, "ensure_synthetic_tree", lambda *a, **k: calls.setdefault("port", (a, k)))
    want = JaxConfig.fromfile(os.path.join(REPO, "configs", "synthetic_fullscale_cfg.py"))
    got = Config.fromfile(os.path.join(REPO, "deepphysinet_tpu_torch", "configs", "synthetic_fullscale_cfg.py"))
    assert calls["port"] == calls["jax"] == ((str(tmp_path / "fullsynth"),),
                                             dict(n_init_times=4, bbox=(72.0, 18.0, 136.0, 54.0)))
    assert sorted(got) == sorted(want) and got["config"]["train_cfg"]["tpu"]["sample_mode"] == "device"

    def walk(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            assert a == b and type(a) is type(b), path

    for key in want:
        walk(got[key], want[key], key)


def test_render_grid_matches_jax_trainer(world):
    """``_render_grid`` under ``with_vis``: both trainers run two steps from one JAX checkpoint at a
    learning rate of 0 (so the parameters of the renders at the log steps, 1 and the last, are the
    checkpoint's in both) and render the six grids of the step's window into jpgs; the grids, file
    names and titles are held to the JAX trainer's, the grids within ``test_torch_port_slice.py``'s
    grid bound (``with_clip=False``)."""
    cfg = copy.deepcopy(world.cfg)
    tc = cfg["train_cfg"]
    tc["optimizer"]["lr"] = tc["lr_schedule"]["eta_min"] = 0.0
    tc["tpu"]["pde_start_step"] = 100
    init = os.path.join(world.work, "render_init")
    jck.save_checkpoint(init, 0, 0, world.params, j_build_optimizer(**tc["optimizer"]).init(world.params),
                        prefix="physics", dx=27000.0, dy=27000.0)
    import deepphysinet_tpu.utils.vis as jvis
    import deepphysinet_tpu_torch.utils.vis as tvis

    renders = {}
    for name, module, vis_module, build in (("jax", jip, jvis, j_builder_models), ("port", tip, tvis, builder_models)):
        run_dir = os.path.join(world.work, f"render_{name}")
        shutil.copytree(init, os.path.join(run_dir, "ckpt"))
        tc["log"].update(with_vis=True, vis_path=os.path.join(run_dir, "vis"))
        seen = renders[name] = {}
        forward = vis_module.VisUtils.forward

        def recording(self, data, out_file, title=None, _forward=forward, _seen=seen):
            _seen[os.path.basename(out_file)] = (np.array(data), title)
            return _forward(self, data, out_file, title)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vis_module.VisUtils, "forward", recording)
            mp.setattr(module, "_summary_writer", lambda *a, **k: types.SimpleNamespace(
                add_scalar=lambda *a, **k: None, close=lambda: None))
            mp.setattr(module.PhysicsDataset, "__getitem__", _seeded_by_window(module.PhysicsDataset.__getitem__))
            kwargs = dict(device="cpu") if name == "port" else {}
            build(**copy.deepcopy(cfg), **kwargs).run_train_interface(
                max_steps=2, checkpoint_path=os.path.join(run_dir, "ckpt"), log_path=os.path.join(run_dir, "log"))
        out_dir = os.path.join(run_dir, "vis", "train_results")
        assert sorted(os.listdir(out_dir)) == sorted(seen), name
    want, got = renders["jax"], renders["port"]
    assert sorted(got) == sorted(want) and len(want) == 12  # six grids at each log step: 1 and the last, 2
    for step in (1, 2):
        for i, key in enumerate(("u", "v", "P", "T", "q", "rio")):
            f = next(n for n in want if n.startswith(f"{step}_result_{key}_f"))
            assert got[f][1] == want[f][1], f
            assert got[f][0].shape == want[f][0].shape == (37, 65)
            np.testing.assert_allclose(got[f][0], want[f][0], rtol=1e-5, atol=world.tol[i], err_msg=f)
