"""PyTorch port against the JAX package: the trainer's parts.

The four learning-rate schedules epoch by epoch; ``PrefetchLoader`` against JAX's on one seeded
dataset (the same batches in the same order, with shards and ``drop_last``; a worker's error reaches
the consumer); resume through ``train/checkpoint.py::restore_train_state`` from the three formats
(the port's ``.pth`` with its Adam state matched by parameter name, a JAX pickle whose optax Adam
moments become torch's exactly, a reference ``.pth`` made by ``export_torch_state_dict``: its
parameters alone); ``allow_partial_resume``; and the two modes that are not ported, each naming its
ROADMAP item.  The models are the tiny ones of ``test_torch_port_train.py``.
"""

import os
import signal

import numpy as np
import pytest
import torch

import jax

from deepphysinet_tpu.data.pipeline import PrefetchLoader as JaxPrefetchLoader
from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.train import checkpoint as jck
from deepphysinet_tpu.train import schedules as jsched
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer
from deepphysinet_tpu.train.torch_import import export_torch_state_dict

from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data.pipeline import PrefetchLoader
from deepphysinet_tpu_torch.interface.interface_physics import InterfacePhysics
from deepphysinet_tpu_torch.train import checkpoint as tck
from deepphysinet_tpu_torch.train import schedules as tsched
from deepphysinet_tpu_torch.train import train_step as tts
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax
from tests.test_torch_port_train import COORD, FACTORS, META, NET, OBS_CFG, OPT, _jax_batch, _numpy_batch

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_train.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEDULES = [
    dict(name="stepLR", step_size=3, gamma=0.5),
    dict(name="CosineAnnealingLR", T_max=7, eta_min=5e-6),
    dict(name="WarmupMultiStepLR", milestones=[4, 9], gamma=0.3, warmup_iters=5, warmup_factor=0.2),
    dict(name="WarmupStepLR", start_epoch=6, step_size=4, step_gamma=0.8, warmup_factor=0.1),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[s["name"] for s in SCHEDULES])
def test_schedules_match_jax_epoch_by_epoch(sched):
    want, got = jsched.build_lr_schedule(lr=1e-3, **sched), tsched.build_lr_schedule(lr=1e-3, **sched)
    assert [got(e) for e in range(20)] == [want(e) for e in range(20)]
    with pytest.raises(ValueError, match="increasing"):
        tsched.build_lr_schedule(name="WarmupMultiStepLR", lr=1e-3, milestones=[5, 2])


class _SeededDataset:
    """Items that depend on the order they are drawn in, as ``PhysicsDataset``'s point draws do."""

    def __init__(self, n, seed, fail_at=None):
        self.n, self.rng, self.fail_at = n, np.random.RandomState(seed), fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"unreadable raster of window {i}")
        return {"idx": np.int64(i), "draw": self.rng.rand(3).astype(np.float32), "input_file": f"window_{i}"}


def _epochs(loader_cls, **kw):
    loader = loader_cls(_SeededDataset(11, seed=3), seed=5, num_workers=1, **kw)
    return len(loader), [list(loader) for _ in range(2)]


@pytest.mark.parametrize("batch_size, drop_last, num_shards", [(2, True, 1), (3, False, 1), (2, True, 2), (2, False, 3)])
def test_prefetch_loader_matches_jax(batch_size, drop_last, num_shards):
    """Two epochs of every shard: the same lengths, window order, draws and file names as JAX's loader."""
    for shard in range(num_shards):
        kw = dict(batch_size=batch_size, drop_last=drop_last, shard_id=shard, num_shards=num_shards)
        (n_j, want), (n_t, got) = _epochs(JaxPrefetchLoader, **kw), _epochs(PrefetchLoader, **kw)
        assert n_t == n_j == sum(1 for _ in want[0]) and n_t > 0
        for ew, eg in zip(want, got):
            assert [b["input_file"] for b in eg] == [b["input_file"] for b in ew]
            for bw, bg in zip(ew, eg):
                assert set(bg) == set(bw)
                np.testing.assert_array_equal(bg["idx"], bw["idx"])
                np.testing.assert_array_equal(bg["draw"], bw["draw"])
    assert [b["idx"].tolist() for b in got[0]] != [b["idx"].tolist() for b in got[1]]  # reshuffled each epoch


def test_prefetch_loader_surfaces_a_worker_error():
    loader = PrefetchLoader(_SeededDataset(6, seed=0, fail_at=4), batch_size=1, shuffle=False, num_workers=2)
    seen = []
    with pytest.raises(OSError, match="window 4"):
        for b in loader:
            seen.append(int(b["idx"][0]))
    assert seen == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="shard_id"):
        PrefetchLoader(_SeededDataset(6, seed=0), shard_id=2, num_shards=2)


# ---- resume ----

def _jax_cfg():
    specs = j_norm_specs(OBS_CFG)
    return jts.StepConfig(coord_spec=JaxCoordSpec(**COORD), obs_specs=tuple(specs[k] for k in J_ORDER),
                          loss_factor=FACTORS)


def _port_cfg():
    specs = norm_specs_from_cfg(OBS_CFG)
    return tts.StepConfig(coord_spec=CoordSpec(**COORD), obs_specs=tuple(specs[k] for k in OBS_NAME_ORDER),
                          loss_factor=FACTORS)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX TrainState after two data-only Adam steps (moments and count non-zero), and the batch."""
    nb = _numpy_batch()
    jmodel = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    tx = j_build_optimizer(**OPT)
    state = jts.create_train_state(jmodel, tx, jax.random.PRNGKey(3), _jax_batch(nb))
    step = jts.make_train_step(jmodel, tx, _jax_cfg())
    for _ in range(2):
        state, _ = step(state, _jax_batch(nb), with_pde=False)
    return dict(state=state, nb=nb)


def _port_state(seed=1):
    return tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(seed), device="cpu")


def _adam(opt_state):
    (adam,) = [s for s in opt_state.inner_state if hasattr(s, "mu")]
    return adam


def test_resume_from_a_jax_pickle_carries_the_adam_moments(jax_run, tmp_path):
    """The optax moments and count become torch Adam's exp_avg, exp_avg_sq and step, bit for bit."""
    js = jax_run["state"]
    jck.save_model(str(tmp_path), 4, 2, js.params, js.opt_state, dx=27000.0)
    payload, epoch, step = tck.load_checkpoint(str(tmp_path))
    assert (epoch, step) == (5, 2)
    state = tck.restore_train_state(_port_state(), payload)
    adam = _adam(js.opt_state)
    mu, nu = state_dict_from_jax(jax.tree.map(np.asarray, adam.mu)), state_dict_from_jax(jax.tree.map(np.asarray, adam.nu))
    params = state_dict_from_jax(jax.tree.map(np.asarray, js.params))
    assert int(adam.count) == 2
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[name]), name
        st = state.optimizer.state[p]
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name]), name
    assert float(sum(st["exp_avg"].abs().sum() for st in state.optimizer.state.values())) > 0
    # the next step runs from that state
    tts.make_train_step(_port_cfg())(state, tts.batch_to_device(jax_run["nb"], device="cpu"), False)
    assert all(float(st["step"]) == 3.0 for st in state.optimizer.state.values())


def test_resume_from_the_ports_pth_matches_the_adam_state_by_name(jax_run, tmp_path):
    """The port's own bundle names the optimizer's parameters; an optimizer built over another order
    of the same parameters gets each one's moments."""
    state = _port_state()
    step = tts.make_train_step(_port_cfg())
    for _ in range(2):
        step(state, tts.batch_to_device(jax_run["nb"], device="cpu"), False)
    tck.save_checkpoint(str(tmp_path), 1, 2, state.model, state.optimizer, dx=27000.0)
    payload, epoch, step_ = tck.load_checkpoint(str(tmp_path))
    assert (epoch, step_, len(payload["param_names"])) == (2, 2, len(list(state.model.parameters())))
    other = _port_state(seed=7)
    other.optimizer = torch.optim.Adam(list(other.model.parameters())[::-1], lr=1.0)
    tck.restore_train_state(other, payload)
    saved = dict(state.model.named_parameters())
    for name, p in other.model.named_parameters():
        assert torch.equal(p.detach(), saved[name].detach()), name
        want, got = state.optimizer.state[saved[name]], other.optimizer.state[p]
        assert torch.equal(got["exp_avg"], want["exp_avg"]) and torch.equal(got["exp_avg_sq"], want["exp_avg_sq"])
        assert float(got["step"]) == 2.0


def test_resume_from_a_reference_pth_loads_the_parameters_alone(jax_run, tmp_path, capsys):
    js = jax_run["state"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(js.params).items()}
    ref_opt = torch.optim.Adam([torch.nn.Parameter(v.clone()) for v in sd.values()])
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3, "gobal_step": 40,
                "optimizer": ref_opt.state_dict()}, tmp_path / "physics_latest.pth")
    payload, epoch, step = tck.load_checkpoint(str(tmp_path))
    assert (epoch, step, "param_names" in payload) == (4, 40, False)
    state = _port_state()
    state.optimizer.state[next(state.model.parameters())]["exp_avg"] = torch.ones(1)  # must go
    tck.restore_train_state(state, payload)
    assert "parameters alone" in capsys.readouterr().out
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), sd[name]), name
    assert len(state.optimizer.state) == 0


def test_partial_resume_raises_without_the_flag_and_resets_the_moments_with_it(jax_run, tmp_path):
    """A JAX pickle of an SGD run holds no Adam moments: a structural mismatch."""
    js = jax_run["state"]
    sgd = j_build_optimizer("SGD", lr=1e-3, momentum=0.9)
    jck.save_model(str(tmp_path), 0, 1, js.params, sgd.init(js.params))
    payload = tck.load_checkpoint(str(tmp_path))[0]
    with pytest.raises(RuntimeError, match="allow_partial_resume"):
        tck.restore_train_state(_port_state(), payload)
    state = _port_state()
    state.optimizer.state[next(state.model.parameters())]["exp_avg"] = torch.ones(1)
    tck.restore_train_state(state, payload, allow_partial_resume=True)
    assert len(state.optimizer.state) == 0
    params = state_dict_from_jax(jax.tree.map(np.asarray, js.params))
    assert all(torch.equal(p.detach(), params[n]) for n, p in state.model.named_parameters())


def test_unported_modes_name_their_roadmap_items(tmp_path, monkeypatch):
    cfg_file = os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py")
    # --dist is ported (A7): ranks on the CPU take gloo only, named; NCCL, the default, refuses them
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="gloo"):
        cli.main(["--config_file", cfg_file, "--mode", "train", "--dist", "--device", "cpu"])
    with pytest.raises(ValueError, match="gloo"):  # several GPUs with the points sampled on the device
        cli.main(["--config_file", cfg_file, "--mode", "train", "--dist", "--device", "cpu",
                  "--set", "train_cfg.tpu.sample_mode=device"])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    from deepphysinet_tpu_torch.config import Config

    cfg = Config.fromfile(cfg_file)["config"]
    before = signal.getsignal(signal.SIGTERM)
    cfg["train_cfg"]["tpu"]["sample_mode"] = "devices"
    with pytest.raises(ValueError, match="unknown sample_mode"):
        InterfacePhysics(**cfg, device="cpu").run_train_interface(checkpoint_path=str(tmp_path))
    cfg["train_cfg"]["tpu"]["ckpt_backend"] = "orbax"
    with pytest.raises(NotImplementedError, match="orbax"):
        InterfacePhysics(**cfg, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
