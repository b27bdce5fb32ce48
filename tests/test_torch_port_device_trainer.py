"""PyTorch port against the JAX package: the trainer with sampling on the device.

As ``test_torch_port_trainer.py`` (the smoke configuration's values on a port-written tree, both
trainers from one JAX checkpoint, float32, summaries caught, ``log_step`` 2), with
``train_cfg.tpu.sample_mode="device"``: the iid sampler over two epochs with ``pde_start_step`` 1
(a data-only step, then three with the PDE terms), and the pool sampler over two epochs with the
PDE terms from the first step.  The port draws from a ``torch.Generator`` where JAX splits keys, so
its draw seam (``device_sampling.draw_points``) replays the JAX loop's draws: the training
generator, seeded ``global_step + 1``, stands for ``PRNGKey(global_step + 1)`` split in blocks of
8,192 subkeys, one a step, each split over the batch's windows; a validation's generator, seeded
7919, for ``PRNGKey(7919)`` split over the windows.  Every logged train and valid metric is held
at ``test_torch_port_train.py``'s ``METRIC_RTOL``, the final parameters by its rule, as in
``test_torch_port_trainer.py``.  Also: the port's cube cache (two builds an epoch's two windows,
then hits only), and the command line's train mode with either sampler.
"""

import copy
import os
import shutil
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

from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree
from deepphysinet_tpu_torch.interface import interface_physics as tip
from deepphysinet_tpu_torch.interface.build import builder_models
from deepphysinet_tpu_torch.train import device_sampling as tds
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax
from tests.test_torch_port_device_sampling import _jax_draws
from tests.test_torch_port_train import METRIC_RTOL
from tests.test_torch_port_trainer import SMOKE_CFG, SMOKE_TREE, _Recorder, _smoke_cfg

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_train.py)

STEPS = 4  # two epochs of two windows
PDE_START = {"iid": 1, "pool": 0}


def _replay_jax_draws():
    """A ``draw_points`` that returns the JAX loop's draws for the port's generators."""
    streams = {}

    def draw(generator, B, scfg, coord_spec):
        seed = generator.initial_seed()
        if seed == 7919:  # a validation: PRNGKey(7919) at every call
            keys = jax.random.split(jax.random.PRNGKey(7919), B)
        else:  # the loop's blocks of subkeys from PRNGKey(global_step + 1)
            st = streams.setdefault(seed, dict(subs=np.asarray(jax.random.split(jax.random.PRNGKey(seed), 8193))[1:],
                                               i=0))
            keys = jax.random.split(jnp.asarray(st["subs"][st["i"]]), B)
            st["i"] += 1
        return _jax_draws(keys, scfg, coord_spec)

    return draw


def _device_cfg(root, sampler):
    cfg = _smoke_cfg(root)
    cfg["train_cfg"]["tpu"].update(sample_mode="device", ds_sampler=sampler, pde_start_step=PDE_START[sampler])
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, a JAX checkpoint of seeded weights, and both trainers' two epochs from it for each
    sampler, each with its summaries caught."""
    root = str(tmp_path_factory.mktemp("device_trainer_tree"))
    ensure_synthetic_tree(root, **SMOKE_TREE)
    cfg = _device_cfg(root, "iid")
    iface = j_builder_models(**copy.deepcopy(cfg))
    rng = np.random.RandomState(2)
    params = iface.physics_net.init(jax.random.PRNGKey(6), jnp.asarray(rng.randn(1, 159, 170).astype(np.float32)),
                                    jnp.zeros((2, 192)), jnp.zeros((2, 6)), jnp.asarray([[0.1]], jnp.float32))
    init = str(tmp_path_factory.mktemp("device_init_ckpt"))
    jck.save_checkpoint(init, 0, 0, params, j_build_optimizer(**cfg["train_cfg"]["optimizer"]).init(params),
                        prefix="physics", dx=27000.0, dy=27000.0)
    runs = {}
    for sampler in ("iid", "pool"):
        cfg = _device_cfg(root, sampler)
        for name, module, build in (("jax", jip, j_builder_models), ("port", tip, builder_models)):
            ckpt_dir = str(tmp_path_factory.mktemp(f"ckpt_{sampler}_{name}"))
            shutil.copytree(init, ckpt_dir, dirs_exist_ok=True)
            rec = _Recorder()
            kwargs = dict(device="cpu") if name == "port" else {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "_summary_writer", lambda *a, **k: rec)
                mp.setattr(tds, "draw_points", _replay_jax_draws())
                iface = build(**copy.deepcopy(cfg), **kwargs)
                state = iface.run_train_interface(checkpoint_path=ckpt_dir,
                                                  log_path=str(tmp_path_factory.mktemp(f"log_{sampler}_{name}")))
            runs[(sampler, name)] = types.SimpleNamespace(state=state, scalars=rec.scalars, iface=iface)
    return types.SimpleNamespace(root=root, cfg=cfg, runs=runs)


@pytest.mark.parametrize("sampler", ["iid", "pool"])
def test_logged_metrics_match_jax(world, sampler):
    want, got = world.runs[(sampler, "jax")].scalars, world.runs[(sampler, "port")].scalars
    assert sorted(got) == sorted(want)
    assert sorted({s for _, s in want}) == [1, 3]  # logged at 1 and 3, no rate summary in this loop
    assert {"training/grad_norm", "training/margin_loss", "validation/total_loss",
            "validation/margin_u_loss"} <= {t for t, _ in want}
    assert (("training/inter_total", 1) in want) == (sampler == "pool")  # pde from step 2 (iid), 1 (pool)
    assert ("training/inter_total", 3) in want and ("validation/inter_total", 3) in want
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], w, rtol=METRIC_RTOL, atol=1e-12, err_msg=str(key))


@pytest.mark.parametrize("sampler", ["iid", "pool"])
def test_final_parameters_match_jax(world, sampler):
    """``test_torch_port_trainer.py``'s rule."""
    lr = world.cfg["train_cfg"]["optimizer"]["lr"]
    reach, atol = 2 * STEPS * lr * 1.01, STEPS * lr * 2e-2
    want = state_dict_from_jax(jax.tree.map(np.asarray, world.runs[(sampler, "jax")].state.params))
    port = world.runs[(sampler, "port")]
    got = port.state.model.state_dict()
    assert sorted(got) == sorted(want)
    off = total = 0
    for k, w in want.items():
        diff = np.abs(got[k].numpy() - w.numpy())
        assert diff.max() <= reach, (k, diff.max())
        if not k.endswith("key_projection.bias"):
            off += int((diff > atol).sum())
            total += diff.size
    assert off <= 1e-4 * total, (off, total)
    assert port.state.step == STEPS


@pytest.mark.parametrize("sampler", ["iid", "pool"])
def test_cube_caches_build_each_window_once(world, sampler):
    iface = world.runs[(sampler, "port")].iface
    cubes = iface.device_sampling.cubes
    assert (cubes.builds, cubes.hits) == (2, 2)
    valid = iface._valid_cubes
    assert (valid.builds, valid.hits, iface.valid_failures) == (1, 1, 0)  # one valid window, two validations
    cube = next(iter(cubes._d.values()))
    assert (cube.pool_rows is not None) == (sampler == "pool") and (cube.label_cube is None) == (sampler == "pool")
    clock = iface.step_clock
    assert len(clock["cube"]) == STEPS and not clock["copy"] and len(clock["fetch"]) == len(clock["valid"]) == 2


@pytest.mark.parametrize("sampler", ["iid", "pool"])
def test_cli_trains_with_device_sampling(world, tmp_path, monkeypatch, sampler):
    """``python -m deepphysinet_tpu_torch.cli --mode train --set train_cfg.tpu.sample_mode=device``
    from scratch, two steps with the PDE terms."""
    monkeypatch.setenv("DPN_SMOKE_DATA", world.root)
    state = cli.main(["--config_file", SMOKE_CFG, "--device", "cpu", "--checkpoints_path", str(tmp_path / "ckpt"),
                      "--mode", "train", "--max_steps", "2", "--log_path", str(tmp_path / "log"),
                      "--set", "train_cfg.tpu.sample_mode=device", "--set", f"train_cfg.tpu.ds_sampler={sampler}",
                      "--set", "train_cfg.tpu.pde_start_step=0", "--set", "train_cfg.num_workers=1"])
    assert state.step == 2 and all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["codes.zip", "physics_0.pth", "physics_latest.pth"]
    log = open(next((tmp_path / "log").glob("log_*.txt"))).read()
    assert log.count("[device-sampled]") == 2 and "valid loss:" in log
