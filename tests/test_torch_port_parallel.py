"""PyTorch port against the JAX package: the data-parallel trainer (``deepphysinet_tpu_torch/parallel/``).

Two ranks over gloo on the CPU, started as ``torchrun`` would start them (``parallel/dryrun.py::launch``:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); each writes its results to a
file, and this process holds them to JAX's sharded steps, run here on the conftest's virtual CPU
devices, on the same mesh, weights and draws:

* one host-sampled PDE step on (data=2) against ``make_sharded_train_step``;
* one device-sampled PDE step on (data=2) and one on (data=1, points=2) against
  ``make_sharded_device_sampling_step`` (the port's ranks take JAX's global draws, as every rank
  draws them from one generator in the trainer, and keep their rows and point chunk);

at the tiny widths and tolerances of ``test_torch_port_train.py`` (float32: every metric at
``METRIC_RTOL``, the parameters after one step by its ``PARAM_ATOL`` rule), and every rank with the
same metrics to the bit.  Then the trainer: ``python -m deepphysinet_tpu_torch.cli --dist
--dist_backend gloo --device cpu`` on two ranks (a smoke tree at 32 wide), host-sampled from a
one-process checkpoint (only rank 0 writes the log, the summaries and the checkpoints; the run resumes
across topologies both ways) and device-sampled with its collective validation; the strided loaders
(each data slot its windows, every window once an epoch); the lead time snapped to the window under
``dist``; the preemption flag's agreement; and ``initialize_distributed``'s rule for ranks that share a
card.
"""

import copy
import dataclasses
import glob
import os
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.parallel import mesh as jmesh
from deepphysinet_tpu.parallel import sharding as jsharding
from deepphysinet_tpu.train import device_sampling as jds
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer

from deepphysinet_tpu_torch import cli
from deepphysinet_tpu_torch.data.pipeline import PrefetchLoader
from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree
from deepphysinet_tpu_torch.interface import interface_physics as tip
from deepphysinet_tpu_torch.interface.build import builder_models
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.parallel import dryrun, multihost
from deepphysinet_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from deepphysinet_tpu_torch.train import checkpoint as tck
from deepphysinet_tpu_torch.train import device_sampling as tds
from deepphysinet_tpu_torch.train import train_step as tts
from deepphysinet_tpu_torch.train.torch_import import load_train_state, state_dict_from_jax
from tests.test_torch_port_device_sampling import COORD as DS_COORD
from tests.test_torch_port_device_sampling import GEOM, JS, TS, _cubes, _jax_draws
from tests.test_torch_port_train import (
    COORD, FACTORS, META, METRIC_RTOL, NET, OBS_CFG, OPT, PARAM_ATOL, _adam_state, _jax_batch, _numpy_batch)
from tests.test_torch_port_trainer import SMOKE_TREE, _smoke_cfg

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_train.py)

CPU_RANKS = ["--backend", "gloo", "--device", "cpu"]


def _cfgs(coord):
    jspecs, tspecs = j_norm_specs(OBS_CFG), norm_specs_from_cfg(OBS_CFG)
    jcfg = jts.StepConfig(coord_spec=JaxCoordSpec(**coord), obs_specs=tuple(jspecs[k] for k in J_ORDER),
                          loss_factor=FACTORS, pde_engine="kernel", kernel_version=7)
    tcfg = tts.StepConfig(coord_spec=CoordSpec(**coord), obs_specs=tuple(tspecs[k] for k in OBS_NAME_ORDER),
                          loss_factor=FACTORS)
    return jcfg, tcfg


def _copy(state):
    return jax.tree.map(lambda x: x.copy() if hasattr(x, "copy") else x, state)


@pytest.fixture(scope="module")
def steps_world(tmp_path_factory):
    """The three sharded steps in two spawned ranks and in JAX on the same meshes, from one JAX init."""
    nb = _numpy_batch(seed=0, B=2)
    jbatch = _jax_batch(nb)
    jm = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    tx = j_build_optimizer(**OPT)
    state0 = jax.jit(lambda key, b: jts.create_train_state(jm, tx, key, b))(jax.random.PRNGKey(0), jbatch)
    port = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), device="cpu")
    count, mu, nu = _adam_state(state0.opt_state)
    load_train_state(port, jax.tree.map(np.asarray, state0.params), mu, nu, count, 0)

    nwp, label = _cubes(21, 2)
    rng = np.random.RandomState(4)
    cube = tds.CubeBatch(field=rng.randn(2, 12, 65).astype(np.float32), forecast_h=np.array([24.0, 30.0], np.float32),
                         nwp_cube=nwp.reshape(-1, 6), label_cube=label.reshape(-1, 6))
    keys = {"device 2x1": jax.random.PRNGKey(31), "device 1x2": jax.random.PRNGKey(33)}
    jcfg_h, tcfg_h = _cfgs(COORD)
    jcfg_d, tcfg_d = _cfgs(GEOM)
    cases = [dict(name="host 2x1", kind="host", mesh=(2, 1), batch=nb, cfg=tcfg_h, with_pde=True)]
    for name, key in keys.items():
        # JAX splits the step's key over the global windows, data slot d keeping its rows: the port's
        # ranks take those draws for every window and keep theirs
        draws = _jax_draws(jax.random.split(key, 2), TS, DS_COORD)
        cases.append(dict(name=name, kind="device", mesh=(2, 1) if name.endswith("2x1") else (1, 2), cube=cube,
                          draws=draws, scfg=TS, cfg=tcfg_d, with_pde=True))
    tmp = str(tmp_path_factory.mktemp("parallel_steps"))
    spec = os.path.join(tmp, "spec.pt")
    torch.save(dict(meta=META, net=NET, opt=OPT, compute_dtype="float32", model_state=port.model.state_dict(),
                    optim_state=port.optimizer.state_dict(), cases=cases), spec)
    ranks = {}
    worker = threading.Thread(target=lambda: ranks.setdefault("out", dryrun.launch(
        2, ["--child", spec, os.path.join(tmp, "out"), *CPU_RANKS])))
    worker.start()  # the ranks run while JAX compiles its three sharded steps

    want = {}
    mesh2 = jmesh.make_mesh(jmesh.MeshConfig(data=2, points=1), devices=jax.devices()[:2])
    st, m = jsharding.make_sharded_train_step(jm, tx, jcfg_h, mesh2)(_copy(state0), jmesh.shard_batch(jbatch, mesh2),
                                                                     True)
    want["host 2x1"] = (m, st)
    jcube = jax.tree.map(jnp.asarray, jds.CubeBatch(*cube))
    for name, key in keys.items():
        mesh = mesh2 if name.endswith("2x1") else jmesh.make_mesh(jmesh.MeshConfig(data=1, points=2),
                                                                   devices=jax.devices()[:2])
        st, m = jsharding.make_sharded_device_sampling_step(jm, tx, jcfg_d, mesh, JS)(_copy(state0), jcube, key, True)
        want[name] = (m, st)
    want = {k: ({n: float(v) for n, v in m.items()}, state_dict_from_jax(jax.tree.map(np.asarray, st.params)))
            for k, (m, st) in want.items()}
    worker.join()
    assert "out" in ranks, "the ranks did not finish"
    return types.SimpleNamespace(want=want, ranks=dryrun.read_results(os.path.join(tmp, "out"), 2),
                                 cases={c["name"]: c for c in cases}, model_state=port.model.state_dict(),
                                 optim_state=port.optimizer.state_dict())


# C6: in float32 the rio_net gradients follow the forward's last bits, and JAX compiles its sharded
# device-sampled step for one window a device, so its forward rounds otherwise than its one-process
# step's: on "device 2x1" the gradient norms of JAX's two programs part by 2.4e-3 on the same weights
# and draws, and after the step their parameters part past PARAM_ATOL / 3 in 3,720 of 124,114 entries,
# while the port's two ranks give JAX's one-process norm to the bit.  So the gradient norm is held to
# JAX's sharded step at 1e-2 and the parameters to Adam's reach; both are held at METRIC_RTOL and by
# the PARAM_ATOL rule to the port's own one-process step on the global batch, which
# test_torch_port_train.py and test_torch_port_device_sampling.py hold to JAX's one-process step.
GRAD_NORM_RTOL = 1e-2


def _one_process(steps_world, case):
    """The port's one-process step on the case's global batch, from the same state."""
    c = steps_world.cases[case]
    state = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), device="cpu")
    state.model.load_state_dict(steps_world.model_state)
    state.optimizer.load_state_dict(steps_world.optim_state)
    if c["kind"] == "host":
        state, m = tts.make_train_step(c["cfg"])(state, tts.batch_to_device(c["batch"], device="cpu"), True)
    else:
        cube = tds.cube_to_device(c["cube"], "cpu")
        state, m = tds.make_device_sampling_train_step(c["cfg"], c["scfg"])(state, cube, c["draws"], True)
    return {k: float(v) for k, v in m.items()}, state


@pytest.mark.parametrize("case", ["host 2x1", "device 2x1", "device 1x2"])
def test_sharded_step_matches_jax(steps_world, case):
    metrics, params = steps_world.want[case]
    r0, r1 = (r["results"][case] for r in steps_world.ranks)
    assert r0["metrics"] == r1["metrics"]  # every rank holds the same averaged metrics
    got = r0["metrics"]
    assert sorted(got) == sorted(metrics)
    assert "inter_vapor_loss" in got and got["skipped_nonfinite"] == 0.0
    for k, w in metrics.items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-12, err_msg=f"{case} {k}")
    one, one_state = _one_process(steps_world, case)
    for k, w in one.items():  # the ranks' step is one process's step over both windows
        np.testing.assert_allclose(got[k], w, rtol=METRIC_RTOL, atol=1e-12, err_msg=f"{case} {k}, one process")
    one_params = one_state.model.state_dict()
    off = total = 0
    for k, w in params.items():
        assert np.abs(r0["params"][k].numpy() - w.numpy()).max() <= 2 * OPT["lr"] * 1.01, k  # Adam's reach
        diff = np.abs(r0["params"][k].numpy() - one_params[k].numpy())
        if not k.endswith("key_projection.bias"):  # test_torch_port_train.py's rule for one step
            off += int((diff > PARAM_ATOL / 3).sum())
            total += diff.size
    assert off <= 1e-4 * total, (case, off, total)
    assert r0["launches"] == {} and steps_world.ranks[0]["device"] == "cpu"  # the plain versions on the CPU


def test_strided_loaders_give_each_slot_its_windows():
    """On a (2, 2) mesh of four ranks each data slot's two ranks load the same windows, the slots
    together every window once an epoch, and the k-th windows of the slots are the k-th global batch."""
    items = [dict(i=np.array([i])) for i in range(7)]
    epoch = {}
    for r in range(4):
        mesh = make_mesh(MeshConfig(data=2, points=2), world=4, rank=r)
        loader = PrefetchLoader(items, 1, shuffle=True, drop_last=True, num_workers=1, shard_id=mesh.data_index,
                                num_shards=mesh.data)
        epoch[r] = [int(b["i"][0, 0]) for b in loader]
    assert epoch[0] == epoch[1] and epoch[2] == epoch[3] and len(epoch[0]) == 3
    assert sorted(epoch[0] + epoch[2]) == sorted(set(epoch[0] + epoch[2]))  # no window twice
    single = [sorted(int(i) for i in b["i"][:, 0]) for b in PrefetchLoader(items, 2, shuffle=True, drop_last=True,
                                                                              num_workers=1)]
    assert [sorted(p) for p in zip(epoch[0], epoch[2])] == single
    assert multihost.process_shard(7) == range(0, 7, 1)  # one process (no group): every item


def test_initialize_distributed_shares_a_card_only_over_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    joined = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda backend, **k: joined.append(backend))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no card of its own"):
        multihost.initialize_distributed()  # NCCL, the default
    with pytest.raises(RuntimeError, match="no card of its own"):
        multihost.initialize_distributed("nccl")
    assert joined == []
    assert multihost.initialize_distributed("gloo") == torch.device("cuda", 0)
    assert joined == ["gloo"]
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert multihost.initialize_distributed("nccl") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        multihost.local_device(0, "nccl", 1, device="cpu")


def test_agreed_preemption_asks_the_ranks_at_its_cadence(monkeypatch):
    """One process reads its own flag at every step; several ranks all-reduce theirs (max) only every
    ``check_every`` steps, a condition on the global step that every rank shares."""
    iface = types.SimpleNamespace(device=torch.device("cpu"))
    agreed = tip.InterfacePhysics._agreed_preemption
    assert agreed(iface, {"flag": True}) and not agreed(iface, {"flag": False})
    asked = []
    monkeypatch.setattr(multihost, "all_ranks_max", lambda flag, device: asked.append(flag) or True)
    assert not agreed(iface, {"flag": False}, 2, global_step=19, check_every=20) and asked == []
    assert agreed(iface, {"flag": False}, 2, global_step=20, check_every=20) and asked == [False]


def _write_cfg(path, cfg):
    with open(path, "w") as fp:
        fp.write(f"mode = 'train'\nconfig = {cfg!r}\n")
    return path


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    """A smoke tree at 32 wide; a one-process run of two steps (checkpoint A); two ranks resume from A
    for two steps (B), host-sampled; two ranks train two steps device-sampled from scratch, with a valid
    split of two windows; one process resumes from B for one step."""
    root = str(tmp_path_factory.mktemp("parallel_tree"))
    ensure_synthetic_tree(root, **SMOKE_TREE)
    cfg = _smoke_cfg(root)
    cfg["meta_cfg"].update(c_out=32, d_model=32, d_ff=32, e_layers=1)
    cfg["net_cfg"].update(hidden_channels=32)
    tc = cfg["train_cfg"]
    tc.update(num_epoch=10)
    tc["tpu"].update(pde_start_step=1)
    for split in ("train_data", "valid_data"):
        tc[split].update(label_batch_size=64, batch_size_inter=32)
    tmp = str(tmp_path_factory.mktemp("parallel_trainer"))
    host_cfg = _write_cfg(os.path.join(tmp, "host_cfg.py"), cfg)
    dcfg = copy.deepcopy(cfg)
    dcfg["train_cfg"]["tpu"].update(sample_mode="device")
    dcfg["train_cfg"]["valid_data"].update(start_time=tc["train_data"]["start_time"],
                                           end_time=tc["train_data"]["end_time"])
    device_cfg = _write_cfg(os.path.join(tmp, "device_cfg.py"), dcfg)
    d = {k: os.path.join(tmp, k) for k in ("a", "b", "c", "d", "log_a", "log_b", "log_c", "log_d")}

    def args(cfg_file, ckpt, log, steps):
        return ["--config_file", cfg_file, "--mode", "train", "--checkpoints_path", ckpt, "--log_path", log,
                "--max_steps", str(steps)]

    cli.main(args(host_cfg, d["a"], d["log_a"], 2) + ["--device", "cpu"])
    def copy_checkpoints(src, dst):
        os.makedirs(dst)
        for f in glob.glob(os.path.join(src, "physics_*.pth")):
            os.link(f, os.path.join(dst, os.path.basename(f)))

    copy_checkpoints(d["a"], d["b"])
    outs = {}
    runs = [("host", args(host_cfg, d["b"], d["log_b"], 4)), ("device", args(device_cfg, d["c"], d["log_c"], 2))]
    threads = [threading.Thread(target=lambda n=n, a=a: outs.setdefault(n, dryrun.launch(
        2, a + ["--dist", "--dist_backend", "gloo", "--device", "cpu"], module="deepphysinet_tpu_torch.cli")))
        for n, a in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(outs) == ["device", "host"], "a two-rank run failed"
    b_payload = tck.load_checkpoint(d["b"], prefix="physics")
    copy_checkpoints(d["b"], d["d"])
    state = cli.main(args(host_cfg, d["d"], d["log_d"], 5) + ["--device", "cpu"])
    return types.SimpleNamespace(d=d, outs=outs, b=b_payload, resumed=state)


def _logs(path):
    return sorted(glob.glob(os.path.join(path, "log_*.txt")))


def test_two_ranks_resume_a_one_process_checkpoint_and_only_rank_0_writes(trainer_world):
    d, outs = trainer_world.d, trainer_world.outs
    assert sorted(os.listdir(d["b"])) == ["codes.zip", "physics_0.pth", "physics_1.pth", "physics_2.pth",
                                          "physics_latest.pth"]  # A's epoch 0, then one step an epoch on 2 ranks
    payload, epoch, step = trainer_world.b
    assert (epoch, step) == (3, 4)
    assert {int(v["step"]) for v in payload["optimizer"]["state"].values()} == {4}  # Adam carried on from A's 2
    (log,) = _logs(d["log_b"])  # rank 1 writes no log file
    text = open(log).read()
    assert "resume from epoch 1 global_step 2" in text and text.count("train loss:") == 2  # steps 3 and 4 (the last)
    assert len(glob.glob(os.path.join(d["log_b"], "events.out.tfevents.*"))) == 1  # rank 0's summaries only
    host = outs["host"]
    assert "mesh: {'data': 2, 'points': 1}; effective window batch: 2" in host[0]
    assert host[0].count("=========training=========") == 2 and "=========training=========" not in host[1]


def test_one_process_resumes_a_two_rank_checkpoint(trainer_world):
    d = trainer_world.d
    (log,) = _logs(d["log_d"])
    assert "resume from epoch 3 global_step 4" in open(log).read()
    assert trainer_world.resumed.step == 5
    payload, _, _ = trainer_world.b
    got = trainer_world.resumed.model.state_dict()
    moved = max(float((got[k].cpu() - v.cpu()).abs().max()) for k, v in payload["model"].items())
    # one Adam step from B's weights: a few lr at most (rates <= 1e-4; a fresh start lies ~0.1 away)
    assert 0 < moved <= 10 * OPT["lr"]


def test_two_ranks_train_device_sampled_with_collective_validation(trainer_world):
    d, outs = trainer_world.d, trainer_world.outs
    (log,) = _logs(d["log_c"])
    text = open(log).read()
    assert text.count("[device-sampled]") == 2 and text.count("valid loss:") == 2  # steps 1 and 2 (the last)
    assert "[device-sampled]" not in outs["device"][1]
    payload, epoch, step = tck.load_checkpoint(d["c"], prefix="physics")
    assert step == 2 and all(bool(torch.isfinite(v).all()) for v in payload["model"].values())


def test_dist_snaps_the_lead_time_to_the_window(trainer_world, tmp_path, monkeypatch):
    """``run_train_interface(dist=True)`` in one process (a mesh of one rank): the host-sampled step's
    configuration snaps the lead time to the 24-hour window; the device-sampled loss keeps it as it is."""
    seen = []
    make = tip.sharding.make_sharded_train_step
    monkeypatch.setattr(tip.sharding, "make_sharded_train_step", lambda cfg, mesh: seen.append(cfg) or make(cfg, mesh))
    from deepphysinet_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(os.path.dirname(trainer_world.d["a"]), "host_cfg.py"))["config"]
    iface = builder_models(**cfg, device="cpu")
    state = iface.run_train_interface(dist=True, max_steps=1, checkpoint_path=str(tmp_path / "ck"),
                                      log_path=str(tmp_path / "log"))
    assert state.step == 1 and [c.forecast_h_snap for c in seen] == [24.0]
    assert tds._unsnapped(seen[0]).forecast_h_snap == 0.0
    fh = torch.tensor([30.0, 47.0, 48.0])
    assert tts._snap_forecast_h(fh, seen[0]).tolist() == [24.0, 24.0, 48.0]
