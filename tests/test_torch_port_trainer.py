"""PyTorch port against the JAX package: training from a GeoTIFF tree with host sampling.

On the smoke configuration's values (``configs/smoke_cpu_cfg.py``) and a tree that the port's
generator wrote, the JAX trainer (``InterfacePhysics.run_train_interface``) and the port's run the
same two epochs from one JAX-initialized checkpoint (``deepphysinet_tpu.train.checkpoint.
save_checkpoint``), each in a directory of its own: float32, one loader worker, seeded datasets,
``CosineAnnealingLR`` over the two epochs, two windows an epoch (the JAX trainer draws one batch
to initialize its parameters, and the port draws it too), ``pde_start_step`` 2 (two data-only
steps, then two with the PDE terms), ``pde_engine='kernel'`` (JAX's XLA twin off the TPU, the port's
plain versions on the CPU).  A loader's worker thread draws that batch and the loader's close races
it, so under load a trainer may draw one window's points or two (ROADMAP C34): in these runs each
window's points come from a generator seeded by the window's index (both packages'
``PhysicsDataset.__getitem__`` wrapped alike), so that the draws do not depend on threads.  ``log_step`` is 2: the trainers log at ``global_step % log_step == 1``
(PARITY.md:107), which never holds at 1, so steps 1 and 3 log, one data-only and one PDE step, each
with its validation batch.  The scalars that both write to their summaries (every metric of a
logged step, train and valid, the learning rate of each epoch) are caught and held to each other
at ``test_torch_port_train.py``'s ``METRIC_RTOL``; the final parameters to its ``PARAM_ATOL`` rule
scaled by the steps taken and the largest learning rate; the checkpoints to the same names (the
port's ``.pth`` for JAX's ``.ckpt``), epochs, steps and metadata.  Also: a SIGTERM mid-epoch, the
test mode against JAX's on one checkpoint (full grid and subsampled, within
``test_torch_port_slice.py``'s ``_tol``), and the command line's train and test modes.
"""

import copy
import glob
import json
import os
import shutil
import signal
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.config import Config
from deepphysinet_tpu.interface import interface_physics as jip
from deepphysinet_tpu.interface.build import builder_models as j_builder_models
from deepphysinet_tpu.train import checkpoint as jck
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer
from deepphysinet_tpu.train.schedules import build_lr_schedule

from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree
from deepphysinet_tpu_torch.interface import interface_physics as tip
from deepphysinet_tpu_torch.interface.build import builder_models
from deepphysinet_tpu_torch.train import checkpoint as tck
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax
from tests.test_torch_port_train import METRIC_RTOL

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_train.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CFG = os.path.join(REPO, "configs", "smoke_cpu_cfg.py")
SMOKE_TREE = dict(n_init_times=3, bbox=(72.0, 18.0, 88.0, 27.0))  # what the smoke configuration generates
STEPS = 4  # two epochs of two windows
META_KEYS = ("dx", "dy", "dt", "pred_x_span", "pred_y_span", "pred_t_span", "label_time_step", "input_variable_cfg",
             "input_time_step", "input_time_step_nums", "obs_norm_cfg", "start_time", "end_time")


def _smoke_cfg(root):
    old = os.environ.get("DPN_SMOKE_DATA")
    os.environ["DPN_SMOKE_DATA"] = root  # the tree is current, so the configuration leaves it as it is
    try:
        cfg = Config.fromfile(SMOKE_CFG)["config"]
    finally:
        if old is None:
            del os.environ["DPN_SMOKE_DATA"]
        else:
            os.environ["DPN_SMOKE_DATA"] = old
    tc = cfg["train_cfg"]
    tc.update(num_workers=1, num_epoch=3)
    tc["train_data"]["seed"], tc["valid_data"]["seed"] = 11, 12
    tc["log"].update(log_step=2, with_vis=False)
    tc["lr_schedule"] = dict(name="CosineAnnealingLR", T_max=2, eta_min=5e-6)
    tc["tpu"].update(pde_start_step=2, pde_engine="kernel")
    return cfg


def _tol(cfg):
    """float32 decode differences of 2e-5 normalized units, in physical units (as
    test_torch_port_slice.py::_tol), in the order of the RMSE keys."""
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER

    return {k: float(cfg["obs_norm_cfg"][k]["norm_factor"][1]) * 2e-5 for k in OBS_NAME_ORDER}


class _Recorder:
    """A summary writer that keeps every scalar: {(tag, step): value}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[(tag, int(step))] = float(value)

    def close(self):
        pass


def _seeded_by_window(getitem):
    """``PhysicsDataset.__getitem__`` with the dataset's generator seeded by the window's index first."""
    def item(self, i):
        self.rng = np.random.RandomState(1000 + int(i))
        return getitem(self, i)

    return item


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, a JAX checkpoint of seeded weights at epoch 0 (its Adam state at zero), and both
    trainers' two epochs from it, each with its summaries caught."""
    root = str(tmp_path_factory.mktemp("trainer_tree"))
    ensure_synthetic_tree(root, **SMOKE_TREE)
    cfg = _smoke_cfg(root)
    iface = j_builder_models(**copy.deepcopy(cfg))
    rng = np.random.RandomState(2)
    params = iface.physics_net.init(jax.random.PRNGKey(6), jnp.asarray(rng.randn(1, 159, 170).astype(np.float32)),
                                    jnp.zeros((2, 192)), jnp.zeros((2, 6)), jnp.asarray([[0.1]], jnp.float32))
    init = str(tmp_path_factory.mktemp("init_ckpt"))
    jck.save_checkpoint(init, 0, 0, params, j_build_optimizer(**cfg["train_cfg"]["optimizer"]).init(params),
                        prefix="physics", dx=27000.0, dy=27000.0)
    runs = {}
    for name, module, build in (("jax", jip, j_builder_models), ("port", tip, builder_models)):
        ckpt_dir = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
        shutil.copytree(init, ckpt_dir, dirs_exist_ok=True)
        rec = _Recorder()
        kwargs = dict(device="cpu") if name == "port" else {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "_summary_writer", lambda *a, **k: rec)
            dataset_cls = module.PhysicsDataset
            mp.setattr(dataset_cls, "__getitem__", _seeded_by_window(dataset_cls.__getitem__))
            state = build(**copy.deepcopy(cfg), **kwargs).run_train_interface(
                checkpoint_path=ckpt_dir, log_path=str(tmp_path_factory.mktemp(f"log_{name}")))
        runs[name] = types.SimpleNamespace(state=state, scalars=rec.scalars, ckpt_dir=ckpt_dir)
    return types.SimpleNamespace(root=root, cfg=cfg, jax=runs["jax"], port=runs["port"], tmp=tmp_path_factory)


def test_logged_metrics_and_learning_rates_match_jax(world):
    want, got = world.jax.scalars, world.port.scalars
    assert sorted(got) == sorted(want)
    steps = sorted({s for _, s in want})
    assert steps == [1, 2, 3, 4]  # logged at 1 and 3; each epoch's rate at its last step
    assert {"training/grad_norm", "training/margin_loss", "validation/total_loss", "training/inter_total",
            "validation/margin_vapor_loss"} <= {t for t, _ in want}
    assert ("training/inter_total", 1) not in want and ("training/inter_total", 3) in want  # pde from step 3
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], w, rtol=METRIC_RTOL, atol=1e-12, err_msg=str(key))
    schedule = build_lr_schedule(lr=world.cfg["train_cfg"]["optimizer"]["lr"], **world.cfg["train_cfg"]["lr_schedule"])
    assert (want[("learning_rate", 2)], want[("learning_rate", 4)]) == (schedule(2), schedule(3))
    final = float(np.asarray(world.jax.state.opt_state.hyperparams["learning_rate"]))  # float32 in JAX
    assert [g["lr"] for g in world.port.state.optimizer.param_groups] == [pytest.approx(final, rel=1e-7)]


def test_final_parameters_match_jax(world):
    """``test_torch_port_train.py``'s rule: every entry within what Adam can put between two runs, and
    all but one in 10,000 (the key-projection biases aside) within the bound a relative gradient
    difference of 2e-2 gives, both scaled by the steps taken at the largest rate."""
    lr = world.cfg["train_cfg"]["optimizer"]["lr"]
    reach, atol = 2 * STEPS * lr * 1.01, STEPS * lr * 2e-2
    want = state_dict_from_jax(jax.tree.map(np.asarray, world.jax.state.params))
    got = world.port.state.model.state_dict()
    assert sorted(got) == sorted(want)
    off = total = 0
    for k, w in want.items():
        diff = np.abs(got[k].numpy() - w.numpy())
        assert diff.max() <= reach, (k, diff.max())
        if not k.endswith("key_projection.bias"):
            off += int((diff > atol).sum())
            total += diff.size
    assert off <= 1e-4 * total, (off, total)
    assert world.port.state.step == STEPS
    assert all(float(s["step"]) == STEPS for s in world.port.state.optimizer.state.values())


def test_checkpoints_match_jax(world):
    """The same files (``.pth`` for ``.ckpt``, beside the initial checkpoint's), epochs, steps and
    metadata bundle."""
    j_files = sorted(os.listdir(world.jax.ckpt_dir))
    t_written = sorted(f for f in os.listdir(world.port.ckpt_dir) if f.endswith(".pth"))
    assert j_files == ["physics_0.ckpt", "physics_1.ckpt", "physics_2.ckpt", "physics_latest.ckpt"]
    assert t_written == ["physics_1.pth", "physics_2.pth", "physics_latest.pth"]
    for epoch in (1, 2, None):
        jp, je, js = jck.load_checkpoint(world.jax.ckpt_dir, current_epoch=epoch)
        tp, te, ts_ = tck.load_checkpoint(world.port.ckpt_dir, current_epoch=epoch)
        assert (te, ts_) == (je, js)
        for key in META_KEYS:
            assert tp[key] == jp[key], key
    assert (te, ts_) == (3, STEPS)
    final = {k: v.numpy() for k, v in tck.load_checkpoint(world.port.ckpt_dir)[0]["model"].items()}
    assert all(np.array_equal(final[k], v.numpy()) for k, v in world.port.state.model.state_dict().items())


def test_sigterm_mid_epoch_saves_latest_and_stops(world, tmp_path):
    """A SIGTERM during the second step: that step ends, ``physics_latest`` holds it with the metadata
    bundle, the loop stops, and the handler the run installed is taken down."""
    ckpt_dir = str(tmp_path / "ckpt")
    shutil.copytree(world.jax.ckpt_dir, ckpt_dir)
    for f in glob.glob(os.path.join(ckpt_dir, "physics_[12]*")) + glob.glob(os.path.join(ckpt_dir, "*latest*")):
        os.remove(f)
    os.rename(os.path.join(ckpt_dir, "physics_0.ckpt"), os.path.join(ckpt_dir, "physics_latest.ckpt"))
    iface = builder_models(**copy.deepcopy(world.cfg), device="cpu")
    to_batch, calls = iface._to_batch, []

    def to_batch_then_sigterm(data):  # batches moved: step 1's, its validation batch, step 2's
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return to_batch(data)

    iface._to_batch = to_batch_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    state = iface.run_train_interface(checkpoint_path=ckpt_dir, log_path=str(tmp_path / "log"))
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 2 and len(calls) == 3
    payload, epoch, step = tck.load_checkpoint(ckpt_dir)
    assert (epoch, step) == (2, 2)  # saved in epoch 1, mid-epoch
    assert set(META_KEYS) <= set(payload) and payload["pred_t_span"] == 86400.0
    assert all(torch.equal(payload["model"][k], v) for k, v in state.model.state_dict().items())


@pytest.mark.parametrize("full_grid", [True, False], ids=["full_grid", "subsampled"])
def test_run_test_interface_matches_jax(world, full_grid):
    """On JAX's final checkpoint: the same RMSE and bias of every variable within ``_tol``, the same
    counts, epoch and step."""
    want = j_builder_models(**copy.deepcopy(world.cfg)).run_test_interface(
        checkpoint_path=world.jax.ckpt_dir, max_windows=1, full_grid=full_grid)
    got = builder_models(**copy.deepcopy(world.cfg), device="cpu").run_test_interface(
        checkpoint_path=world.jax.ckpt_dir, max_windows=1, full_grid=full_grid)
    assert sorted(got) == sorted(want)
    tol = _tol(world.cfg)
    for k, w in want.items():
        var = k.split("_", 1)[1].split("_f")[0] if k.startswith(("rmse_", "bias_")) else None
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=tol[var] if var else 0.0, err_msg=k)
    assert (got["epoch"], got["global_step"]) == (2.0, float(STEPS))
    assert got["n_points"] == (37 * 65 * 25 if full_grid else 512)


def test_cli_trains_and_tests(world, tmp_path, monkeypatch):
    """``python -m deepphysinet_tpu_torch.cli --mode train --max_steps 2`` from scratch, then ``--mode
    test`` on what it wrote (its JSON line)."""
    monkeypatch.setenv("DPN_SMOKE_DATA", world.root)
    base = ["--config_file", SMOKE_CFG, "--device", "cpu", "--checkpoints_path", str(tmp_path / "ckpt")]
    state = cli.main(base + ["--mode", "train", "--max_steps", "2", "--log_path", str(tmp_path / "log"),
                             "--set", "train_cfg.num_workers=1"])
    assert state.step == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["codes.zip", "physics_0.pth", "physics_latest.pth"]
    import zipfile

    assert "interface/interface_physics.py" in zipfile.ZipFile(tmp_path / "ckpt" / "codes.zip").namelist()
    out = cli.main(base + ["--mode", "test"])
    assert out["full_grid"] == 1.0 and out["global_step"] == 2.0
    assert all(np.isfinite(out[f"rmse_{k}"]) for k in ("t2", "u10", "v10", "pres", "q2", "rio"))
