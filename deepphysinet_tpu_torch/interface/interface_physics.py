"""InterfacePhysics: the training, test and inference runtime of the port.

Counterpart of ``deepphysinet_tpu/interface/interface_physics.py``.  Orchestration stays on the host:
datasets, epochs, logging, checkpoints.  Two ways to feed the step, by ``train_cfg.tpu.sample_mode``:

* ``"host"`` (the flagship's): each batch of the ``PrefetchLoader`` (points drawn and interpolated
  by ``PhysicsDataset.__getitem__``) goes to the device and through the training step
  (``train/train_step.py``), which on a GPU launches the step's decode kernels;
* ``"device"``: the loader delivers a window's cubes (``get_cube_item``), which stay on the device in
  an LRU of ``tpu.device_cube_cache`` windows, and every step draws fresh points there
  (``train/device_sampling.py``, ``tpu.ds_sampler`` ``'iid'`` or ``'pool'``) from one
  ``torch.Generator`` seeded ``global_step + 1``; validation draws a valid window's points on the
  device from a generator seeded 7919 at each call (the same points every time), rotating over
  ``tpu.valid_windows`` cached windows (``tpu.device_valid`` turns it off).

Kept from the JAX interface: the ``pde_start_step`` curriculum, the per-epoch learning rate of
``train/schedules.py`` written into the optimizer at every epoch end and at the resumed epoch, one
validation batch at each log step, the log cadence ``global_step % log_step == 1`` (a documented
divergence from the reference, PARITY.md:107), the log line and its ``training/`` and
``validation/`` summaries, epoch checkpoints with the metadata bundle (off the loop's thread
except the last), the SIGTERM save of ``physics_latest``, and resume with the optimizer's state.

Differences:

* the model and its torch optimizer live in a ``TrainState`` that the step updates in place;
* the metrics of a log step come to the host in one ``torch.stack(...).cpu()``;
* ``pde_engine`` defaults to ``'kernel'`` on every device (``train_step.default_pde_engine``,
  ROADMAP C18); JAX picks ``'jvp'`` off the TPU only because its kernel op has no GPU body;
* checkpoints are the ``.pth`` bundles of ``train/checkpoint.py`` (``ckpt_backend`` ``'pickle'``);
  the orbax backend is not ported;
* the SIGTERM handler that a run installs is taken down when the run ends;
* ``step_clock`` holds each step's host-clock split (loader, copy to the device or cube lookup,
  step, metric fetch, validation, checkpoint save), for ``chip_smoke.py``;
* the device-sampled loop logs and validates on the loop's thread (JAX hands the metric fetch to a
  worker thread and drops a log event when that thread falls behind), and it draws from a
  ``torch.Generator`` where JAX splits keys in blocks of 8,192 (ROADMAP C37);
* the data-parallel run (``run_train_interface_dist``, ``cli.py --dist`` under ``torchrun``) is one
  process a rank (``parallel/``), where JAX drives a mesh from one controller a host: the ranks of a
  data slot load its windows by strided loaders (``PrefetchLoader(shard_id, num_shards)``), each takes
  its chunk of their points, and the steps average gradients and metrics over every rank
  (``parallel/sharding.py``); the window batch is ``batch_size`` x ``mesh.data``; the lead time snaps
  to the window under ``--dist`` (the device-sampled loss keeps it unsnapped, C38); validation is a
  collective; only rank 0 logs, writes summaries and saves, synchronously with more than one rank;
  the preemption flag is all-reduced every ``tpu.preempt_check_step`` steps.  Not ported: the mesh
  helpers ``_trim_points_multiple`` and ``_feasible_valid_batch`` (a valid point count that does not
  split over ``points`` raises).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import threading
import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
from deepphysinet_tpu_torch.data.pipeline import PrefetchLoader
from deepphysinet_tpu_torch.data.window import DatasetWindows, Window
from deepphysinet_tpu_torch.device import resolve_device
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.parallel import multihost
from deepphysinet_tpu_torch.parallel import sharding
from deepphysinet_tpu_torch.parallel.mesh import MeshConfig, make_mesh, shard_batch
from deepphysinet_tpu_torch.registry import INTERFACES
from deepphysinet_tpu_torch.train import checkpoint as ckpt
from deepphysinet_tpu_torch.train import device_sampling as ds
from deepphysinet_tpu_torch.train.optim import set_learning_rate
from deepphysinet_tpu_torch.train.schedules import build_lr_schedule
from deepphysinet_tpu_torch.train.train_step import (
    Batch, StepConfig, TrainState, batch_to_device, create_train_state, default_pde_engine, make_eval_step,
    make_train_step, step_config_from_cfg)
from deepphysinet_tpu_torch.utils.time_metric import TimeMetric

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "f32": torch.float32, "bf16": torch.bfloat16}
STEP_PARTS = ("loader", "copy", "cube", "step", "fetch", "valid", "save")


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _summary_writer(log_path: str):
    """tensorboardX's writer; a no-op with a warning when tensorboardX is not installed."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_path)
    except ImportError as e:
        import warnings

        warnings.warn(f"tensorboardX unavailable ({e}); scalar summaries will NOT be recorded for this run "
                      "(text log + checkpoints are unaffected)", RuntimeWarning, stacklevel=2)
        return _NullWriter()


class _CubeView:
    """A dataset's windows as ``get_cube_item`` dicts, for the loader of the device-sampled loop."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset.get_cube_item(i)


def sampler_config(dataset) -> ds.SamplerConfig:
    """The device sampler's geometry and point counts of a dataset's split."""
    return ds.SamplerConfig(
        n_margin=dataset.label_batch_size, n_inter=dataset.inter_batch_size,
        window_h=dataset.input_time_step * dataset.input_time_step_nums, input_time_step=dataset.input_time_step,
        label_time_step=int(dataset.label_time_step), begin_lat=dataset.begin_lat, begin_lon=dataset.begin_lon,
        fine_step=float(dataset.out_lon[1] - dataset.out_lon[0]),
        coarse_step=float(dataset.in_lon[1] - dataset.in_lon[0]))


class _DeviceSampledSteps:
    """What the device-sampled loop adds to the epochs: the loader of window cubes (two threads, a
    window a batch), the device's cube cache (``cubes``: ``tpu.device_cube_cache`` windows), the
    generator of the draws (seeded ``global_step + 1``) and the step.  With a ``mesh`` the loader
    strides over the data slots and every rank draws the global draws of ``mesh.data`` windows and
    keeps its slot's (``parallel/sharding.py``).  With ``DPN_LOOP_PROF`` set, the loop's time a step
    by part after 200 steps of warm-up, printed at its end."""

    def __init__(self, iface, train_dataset, cfg, global_step: int, mesh=None):
        tpu_cfg = iface.train_cfg.get("tpu", {})
        self.device = iface.device
        self.cfg = cfg
        self.mesh = mesh
        self.scfg = sampler_config(train_dataset)
        self.use_pool = iface.ds_sampler == "pool"
        self.train_step = (ds.make_device_sampling_train_step(cfg, self.scfg) if mesh is None
                           else sharding.make_sharded_device_sampling_step(cfg, mesh, self.scfg))
        self.generator = torch.Generator(device=self.device).manual_seed(int(global_step) + 1)
        shards = dict(shard_id=mesh.data_index, num_shards=mesh.data) if mesh is not None else {}
        self.loader = PrefetchLoader(_CubeView(train_dataset), batch_size=1, shuffle=True, drop_last=True,
                                     num_workers=2, **shards)
        self.cubes = ds.DeviceLRU(int(tpu_cfg.get("device_cube_cache", 8)))
        self.prof = (dict(loader=0.0, cube=0.0, key=0.0, dispatch=0.0, steps=0)
                     if os.environ.get("DPN_LOOP_PROF") else None)

    def cube(self, data) -> ds.CubeBatch:
        """A loader batch's window on the device, from the cache or built once (with the pool and
        its conditioning under ``ds_sampler='pool'``)."""
        scfg, coord_spec = self.scfg, self.cfg.coord_spec

        def build():
            cube = ds.cube_batch_host(
                data["field_data"], data["forecast_h"], data["nwp_cube"], data["label_cube"],
                pool_pad=scfg.n_margin if self.use_pool else None,
                pool_seeds=[ds._pool_seed_of(f) for f in data["input_file"]] if self.use_pool else None,
                keep_label_cube=not self.use_pool, expect_dims=ds.expected_cube_dims(scfg, coord_spec))
            cube = ds.cube_to_device(cube, self.device)
            return ds.attach_pool_nwp(cube, scfg, coord_spec) if self.use_pool else cube

        return self.cubes.get(tuple(data["input_file"]), build)

    def step(self, state, cube: ds.CubeBatch, with_pde: bool):
        t0 = time.perf_counter()
        n_windows = cube.field.shape[0] * (self.mesh.data if self.mesh is not None else 1)
        draws = ds.draw_points(self.generator, n_windows, self.scfg, self.cfg.coord_spec)
        t1 = time.perf_counter()
        out = self.train_step(state, cube, draws, with_pde)
        if self.prof is not None:
            self.prof["key"] += t1 - t0
            self.prof["dispatch"] += time.perf_counter() - t1
        return out

    def profile(self, loader_s: float, cube_s: float, end: float) -> None:
        prof = self.prof
        if prof is None:
            return
        prof["loader"] += loader_s
        prof["cube"] += cube_s
        prof["steps"] += 1
        prof["_end"] = end  # leaves out the final epoch save
        if prof["steps"] == 200 and "_start" not in prof:  # cut the warm-up
            for k in ("loader", "cube", "key", "dispatch"):
                prof[k] = 0.0
            prof["steps"] = 0
            prof["_start"] = time.perf_counter()

    def print_profile(self) -> None:
        prof = self.prof
        if prof is None or prof["steps"] == 0 or "_start" not in prof:
            return
        n = prof["steps"]
        total = (prof["_end"] - prof["_start"]) / n * 1e3
        parts = {k: prof[k] / n * 1e3 for k in ("loader", "cube", "key", "dispatch")}
        print("[loop-prof] steps:%d total:%.3f ms/step  loader:%.3f cube:%.3f key:%.3f dispatch:%.3f other:%.3f"
              % (n, total, parts["loader"], parts["cube"], parts["key"], parts["dispatch"],
                 total - sum(parts.values())))


@INTERFACES.register("InterfacePhysics")
class InterfacePhysics:
    def __init__(self, meta_cfg: dict, net_cfg: dict, obs_norm_cfg: dict, variable_cfg: dict, train_cfg: dict,
                 test_cfg: Optional[dict] = None, inference_cfg: Optional[dict] = None, device=None, **kwargs):
        """The configuration's sections (``configs/*.py``, ``config``); ``device=None`` is the first
        CUDA device, an error without one (the CPU tests pass ``device="cpu"``)."""
        self.meta_cfg = dict(meta_cfg)
        self.net_cfg = dict(net_cfg)
        self.obs_norm_cfg = dict(obs_norm_cfg)
        self.variable_cfg = dict(variable_cfg)
        self.train_cfg = dict(train_cfg)
        self.test_cfg = dict(test_cfg or {})
        self.inference_cfg = dict(inference_cfg or {})

        tpu_cfg = dict(self.train_cfg.get("tpu", {}))
        self.compute_dtype = _DTYPES[str(tpu_cfg.get("compute_dtype", "float32")).lower()]
        self.attn_impl = tpu_cfg.get("attn_impl")
        self.pde_start_step = int(tpu_cfg.get("pde_start_step", 2000))
        self.sample_mode = str(tpu_cfg.get("sample_mode", "host"))
        # the device sampler's margin draw: 'iid' = the reference's per-point uniform draw (a row
        # gather each point), 'pool' = one contiguous slice of a per-window permuted label pool
        self.ds_sampler = str(tpu_cfg.get("ds_sampler", "iid"))
        # device-mode validation at every log step (False isolates the loop's own throughput)
        self.device_valid = bool(tpu_cfg.get("device_valid", True))
        self.valid_failures = 0  # device-mode validations that failed (each reported, three in a row fatal)
        self.kernel_version = int(tpu_cfg.get("kernel_version", 7))
        self.packed_assembly = bool(tpu_cfg.get("packed_assembly", True))
        self.ckpt_backend = str(tpu_cfg.get("ckpt_backend", "pickle"))
        if self.ckpt_backend == "orbax":
            raise NotImplementedError("ckpt_backend='orbax' is not ported (a JAX library); the port saves the "
                                      "reference's .pth bundles (ckpt_backend='pickle')")
        if self.ckpt_backend != "pickle":
            raise ValueError(f"unknown ckpt_backend {self.ckpt_backend!r} (pickle|orbax)")
        # explicit None means "auto", as an absent key (and as attn_impl)
        self.pde_engine = str(tpu_cfg.get("pde_engine") or default_pde_engine(self.obs_norm_cfg))
        self.device = resolve_device(device)

        img_size = self.train_cfg["img_size"]
        if isinstance(img_size, (int, float)):
            self.lat_size = self.lon_size = int(img_size)
        else:
            self.lat_size, self.lon_size = img_size

    def _config(self) -> dict:
        """The configuration dict the interface was built from."""
        return dict(meta_cfg=self.meta_cfg, net_cfg=self.net_cfg, obs_norm_cfg=self.obs_norm_cfg,
                    variable_cfg=self.variable_cfg, train_cfg=self.train_cfg, test_cfg=self.test_cfg,
                    inference_cfg=self.inference_cfg)

    def _dataset(self, data_cfg: Mapping) -> PhysicsDataset:
        return PhysicsDataset(**data_cfg, input_variable_cfg=self.variable_cfg, out_variable_cfg=self.obs_norm_cfg,
                              dx=float(self.train_cfg["dx"]), dy=float(self.train_cfg["dy"]))

    # ---- batch conversion ----

    def _to_batch(self, data: Dict[str, np.ndarray]) -> Batch:
        """A loader batch (the dataset's keys) as a ``Batch`` on the run's device."""
        def points(p: str, nwp: str, labels: Optional[str]):
            out = dict(x=data[f"{p}_x"], y=data[f"{p}_y"], t=data[f"{p}_t"], f=data[f"{p}_f"], nwp=data[nwp])
            if labels is not None:
                out["labels"] = data[labels]
            return out

        return batch_to_device(dict(field=data["field_data"], forecast_h=np.asarray(data["forecast_h"]).reshape(-1),
                                    margin=points("margin", "margin_input_data", "margin_data"),
                                    inter=points("inter", "inter_data", None)), device=self.device)

    def _step_cfg(self, pred_t_span: float, forecast_time_period: float, forecast_h_snap: float = 0.0) -> StepConfig:
        return step_config_from_cfg(self._config(), pred_t_span, forecast_time_period=float(forecast_time_period),
                                    forecast_h_snap=float(forecast_h_snap), pde_engine=self.pde_engine,
                                    kernel_version=self.kernel_version, packed_assembly=self.packed_assembly)

    @staticmethod
    def _fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Every scalar of a step in one device-to-host copy."""
        keys = sorted(metrics.keys())
        vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
        return dict(zip(keys, vals))

    # ---- training ----

    def run_train_interface(self, max_steps: Optional[int] = None, checkpoint_path: Optional[str] = None,
                            log_path: Optional[str] = None, dist: bool = False, **kwargs) -> TrainState:
        """Train from ``train_cfg``: resume from ``physics_latest`` in the checkpoint directory or
        start afresh, then the epochs; stop after ``max_steps`` optimizer steps if given.  Returns the
        final ``TrainState``.  ``dist=True`` runs this rank's part of a data-parallel run over the
        process group (``run_train_interface_dist``) on ``train_cfg.tpu.mesh``."""
        if self.sample_mode not in ("host", "device"):
            raise ValueError(f"unknown sample_mode {self.sample_mode!r} (host|device)")
        tc = self.train_cfg
        tpu_cfg = dict(tc.get("tpu", {}))
        batch_size = tc["batch_size"]
        num_epoch = tc["num_epoch"]
        num_workers = tc.get("num_workers", 2)
        self.dx = float(tc["dx"])
        self.dy = float(tc["dy"])
        time_step = tc.get("lable_time_step", tc.get("label_time_step", 1))
        self.dt = float(60 * 60 * time_step)

        checkpoint_path = checkpoint_path or tc["checkpoints"]["checkpoints_path"]
        log_path = log_path or tc["log"]["log_path"]
        save_step = tc["checkpoints"].get("save_step", 1)
        log_step = tc["log"].get("log_step", 100)
        with_vis = tc["log"].get("with_vis", False)
        vis_path = tc["log"].get("vis_path", "")
        os.makedirs(log_path, exist_ok=True)
        os.makedirs(checkpoint_path, exist_ok=True)
        # the mesh first: one window a data slot, so the run's window batch is batch_size x data
        # (the reference's DDP gives each rank its own windows, interface_physics.py:899-936)
        nproc = multihost.world_size()
        mesh = None
        if dist:
            mesh = make_mesh(MeshConfig(**dict(tpu_cfg.get("mesh", {}))))
            if multihost.rank() == 0:
                print(f"mesh: {mesh.shape}; effective window batch: {batch_size * mesh.data}")
        elif nproc > 1:
            raise RuntimeError("several ranks without the dist path: call run_train_interface_dist")
        is_main = multihost.rank() == 0
        shards = dict(shard_id=mesh.data_index, num_shards=mesh.data) if mesh is not None else {}

        train_dataset = self._dataset(tc["train_data"])
        valid_dataset = self._dataset(tc["valid_data"])
        window_h = train_dataset.input_time_step * train_dataset.input_time_step_nums
        pred_t_span = float(window_h * 3600)
        self.pred_t_span = pred_t_span
        # the dist path snaps lead times to the window grid (reference interface_physics.py:996-997);
        # the single-process path normalizes them as they are
        cfg = self._step_cfg(pred_t_span, train_dataset.forecast_time_period,
                             forecast_h_snap=float(window_h) if dist else 0.0)

        sched_cfg = tc.get("lr_schedule")
        opt_cfg = dict(tc["optimizer"])
        base_lr = float(opt_cfg.get("lr", 1e-4))
        schedule = build_lr_schedule(lr=base_lr, **sched_cfg) if sched_cfg else (lambda e: base_lr)
        train_loader = PrefetchLoader(train_dataset, batch_size, shuffle=True, drop_last=True, num_workers=num_workers,
                                      **shards)
        valid_loader = PrefetchLoader(valid_dataset, batch_size, shuffle=True, drop_last=True, num_workers=1, **shards)

        # ---- state init / resume ----
        payload, current_epoch, global_step = ckpt.load_checkpoint(checkpoint_path, prefix="physics")
        # The JAX trainer draws one batch to initialize its parameters; drawing it here too keeps the
        # loader's shuffles and the dataset's point draws in step with it.
        next(iter(train_loader))
        state = create_train_state(self.meta_cfg, self.net_cfg, opt_cfg, torch.Generator().manual_seed(0),
                                   compute_dtype=self.compute_dtype, device=self.device, attn_impl=self.attn_impl)
        if payload is not None:
            print(f"resume from epoch {current_epoch} global_step {global_step}")
            ckpt.restore_train_state(state, payload, bool(tpu_cfg.get("allow_partial_resume", False)))
            state.step = global_step
        # the log file and the summaries on rank 0 only: on a shared file system two ranks starting in the
        # same second would write the same log file
        date_str = datetime.datetime.now().strftime("%Y-%m-%d_%H_%M_%S")
        log_fp = open(os.path.join(log_path, f"log_{date_str}.txt") if is_main else os.devnull, "w")
        summary = _summary_writer(log_path) if is_main else _NullWriter()
        if payload is not None:
            log_fp.write(f"resume from epoch {current_epoch} global_step {global_step}\n")
        # a resumed run starts at schedule(current_epoch), not the optimizer's base rate
        lr = schedule(max(current_epoch, 0))
        set_learning_rate(state.optimizer, lr)
        print("set lr to:", lr)

        device_mode = self.sample_mode == "device"
        if device_mode:
            sampled = self.device_sampling = _DeviceSampledSteps(self, train_dataset, cfg, global_step, mesh)
            loader = sampled.loader
        elif mesh is not None:
            train_step = sharding.make_sharded_train_step(cfg, mesh)
            eval_step = sharding.make_sharded_eval_step(cfg, mesh)
            loader = train_loader
        else:
            train_step = make_train_step(cfg)
            eval_step = make_eval_step(cfg)
            loader = train_loader

        def local(batch: Batch) -> Batch:
            """This rank's point chunk of its windows (a data slot's loader delivers its windows)."""
            return batch if mesh is None else shard_batch(batch, mesh, rows=False)
        time_metric = TimeMetric()
        loop_metric = TimeMetric()  # never reset: the device-sampled log line's t:
        # SIGTERM: finish the step, save physics_latest, stop (the reference resumes at epoch ends only)
        preempted = {"flag": False}
        previous_handler = self._install_preemption_handler(preempted)
        preempt_check = int(tpu_cfg.get("preempt_check_step", 20))  # the ranks' agreement cadence
        # epoch saves off the loop's thread with one process; with more, synchronous rank-0 saves
        async_ckpt = ckpt.AsyncCheckpointer() if bool(tpu_cfg.get("async_ckpt", True)) and nproc == 1 else None
        meta_kwargs = dict(
            dx=self.dx, dy=self.dy, dt=self.dt,
            pred_x_span=self.dx * self.lon_size,
            pred_y_span=self.dy * self.lat_size,
            pred_t_span=pred_t_span,
            label_time_step=time_step,
            input_variable_cfg=self.variable_cfg,
            input_time_step=train_dataset.input_time_step,
            input_time_step_nums=train_dataset.input_time_step_nums,
            obs_norm_cfg=self.obs_norm_cfg,
            start_time=str(train_dataset.start_time),
            end_time=str(train_dataset.end_time),
        )
        clock = self.step_clock = {k: [] for k in STEP_PARTS}
        valid_iter: Iterator = iter(valid_loader)
        steps_since_log = 0
        stop = False
        preemption_saved = False
        try:
            for epoch in range(current_epoch, num_epoch):
                if stop:
                    break
                t0 = time.perf_counter()
                for batch_id, data in enumerate(loader):
                    t1 = time.perf_counter()
                    with_pde = bool(tc.get("with_pde", True)) and global_step >= self.pde_start_step
                    global_step += 1
                    if device_mode:
                        cube = sampled.cube(data)
                        t2 = time.perf_counter()
                        state, metrics = sampled.step(state, cube, with_pde)
                        clock["cube"].append(t2 - t1)
                    else:
                        batch = local(self._to_batch(data))
                        t2 = time.perf_counter()
                        state, metrics = train_step(state, batch, with_pde)
                        clock["copy"].append(t2 - t1)
                    t3 = time.perf_counter()
                    clock["loader"].append(t1 - t0)
                    clock["step"].append(t3 - t2)
                    if device_mode:
                        sampled.profile(t1 - t0, t2 - t1, t3)
                    steps_since_log += 1

                    if device_mode and (global_step % log_step == 1 or (max_steps and global_step >= max_steps)):
                        fps = time_metric.get_fps(steps_since_log)
                        time_metric.reset()
                        steps_since_log = 0
                        self._log_device_sampled(sampled, valid_dataset, cfg, state, metrics, with_pde, epoch,
                                                 num_epoch, global_step, fps, loop_metric.get_time(), log_fp,
                                                 summary, clock, t3, is_main)
                    elif global_step % log_step == 1 or (max_steps and global_step >= max_steps):
                        fps = time_metric.get_fps(steps_since_log * batch_size * (mesh.data if mesh else 1))
                        time_metric.reset()
                        steps_since_log = 0
                        t4 = t3
                        if is_main:  # every rank holds the same averaged metrics; rank 0 reads and writes them
                            m = self._fetch_metrics(metrics)
                            t4 = time.perf_counter()
                            clock["fetch"].append(t4 - t3)
                            fh = float(np.asarray(data["forecast_h"]).reshape(-1)[0])
                            line = ",".join([
                                f"epoch:{epoch}/{num_epoch}", f"batch:{batch_id}/{len(train_loader)}",
                                f"iter:{global_step}", f"train loss:{m['total_loss']:.6f}",
                                f"margin_loss:{m['margin_loss']:.6f}", f"forecast:{int(fh):03d}h",
                                f"grad:{m['grad_norm']:.3e}", f"fps:{fps:.3f}"])
                            print("=========training=========")
                            print(line)
                            log_fp.write(line + "\n")
                            log_fp.flush()
                            for k, v in m.items():
                                summary.add_scalar(f"training/{k}", v, global_step)
                            summary.add_scalar(f"training_f{int(fh):03d}/margin_loss", m["margin_loss"], global_step)

                        # ---- the interleaved validation batch (reference :639-751); with several ranks
                        # a collective every rank enters, rank 0 logs ----
                        vdata = None
                        if len(valid_loader) > 0:
                            try:
                                vdata = next(valid_iter)
                            except StopIteration:
                                valid_iter = iter(valid_loader)
                                vdata = next(valid_iter)
                        if vdata is not None:
                            vmetrics = eval_step(state.model, local(self._to_batch(vdata)), with_pde)
                        if vdata is not None and is_main:
                            vm = self._fetch_metrics(vmetrics)
                            vline = f"valid loss:{vm['total_loss']:.6f},margin:{vm['margin_loss']:.6f}"
                            print("=========validation=========")
                            print(vline)
                            log_fp.write(vline + "\n")
                            for k, v in vm.items():
                                summary.add_scalar(f"validation/{k}", v, global_step)
                            clock["valid"].append(time.perf_counter() - t4)

                        if with_vis and vis_path and nproc == 1:
                            self._render_grid(state.model, train_dataset, data, cfg,
                                              os.path.join(vis_path, "train_results"), global_step, with_pde)

                    if self._agreed_preemption(preempted, nproc, global_step, preempt_check):
                        if is_main:
                            self._preemption_save(async_ckpt, checkpoint_path, epoch, global_step, state,
                                                  **meta_kwargs)
                        preemption_saved = True
                        stop = True
                        break
                    if max_steps and global_step >= max_steps:
                        stop = True
                        break
                    t0 = time.perf_counter()

                is_last = stop or epoch == num_epoch - 1
                # the rate steps once per epoch, as the reference's scheduler (:831-837), not only on save epochs
                lr = schedule(epoch + 1)
                set_learning_rate(state.optimizer, lr)
                if (epoch % save_step == 0 or is_last) and not preemption_saved and is_main:
                    if not device_mode:  # the JAX device-sampled loop writes no rate summary
                        summary.add_scalar("learning_rate", lr, global_step)
                    t_save = time.perf_counter()
                    self._epoch_save(async_ckpt, is_last, checkpoint_path, epoch, global_step, state, meta_kwargs)
                    clock["save"].append(time.perf_counter() - t_save)
            if device_mode:
                sampled.print_profile()
            if async_ckpt is not None:
                async_ckpt.close()  # drain in-flight saves
            if nproc > 1:  # every rank returns after rank 0's last save is on disk
                torch.distributed.barrier()
        finally:
            # never leak a mid-write checkpoint past an exception
            if async_ckpt is not None:
                async_ckpt.close_quietly()
            valid_iter.close()
            log_fp.close()
            summary.close()
            self._restore_preemption_handler(previous_handler)
        return state

    def _log_device_sampled(self, sampled, valid_dataset, cfg, state, metrics, with_pde, epoch, num_epoch,
                            global_step, fps, elapsed, log_fp, summary, clock, t_step, is_main: bool = True) -> None:
        """A log step of the device-sampled loop: its validation, then one device-to-host copy of
        the train and valid scalars, the ``[device-sampled]`` line and the summaries.  With several
        ranks the validation is a collective that every rank enters; rank 0 alone reads and writes."""
        vm_arrays = None
        mesh = sampled.mesh
        if mesh is not None and multihost.world_size() > 1:
            if self.device_valid and len(valid_dataset) >= mesh.data:
                vm_arrays = self._device_mode_validation_dist(valid_dataset, cfg, sampled.scfg, state, with_pde, mesh)
        elif self.device_valid and len(valid_dataset) > 0:
            vm_arrays = self._device_mode_validation(valid_dataset, cfg, sampled.scfg, state, with_pde, fetch=False)
        if not is_main:
            return
        t_valid = time.perf_counter()
        fetch = dict(metrics)
        if vm_arrays is not None:
            fetch.update({"valid:" + k: v for k, v in vm_arrays.items()})
        got = self._fetch_metrics(fetch)
        clock["valid"].append(t_valid - t_step)
        clock["fetch"].append(time.perf_counter() - t_valid)
        m = {k: v for k, v in got.items() if not k.startswith("valid:")}
        vm = {k[6:]: v for k, v in got.items() if k.startswith("valid:")} or None
        line = (f"[device-sampled] epoch:{epoch}/{num_epoch},iter:{global_step},train loss:{m['total_loss']:.6f},"
                f"margin:{m['margin_loss']:.6f},grad:{m['grad_norm']:.3e},fps:{fps:.3f},t:{elapsed:.1f}s")
        print(line)
        log_fp.write(line + "\n")
        log_fp.flush()
        for k, v in m.items():
            summary.add_scalar(f"training/{k}", v, global_step)
        if vm is not None:
            vline = f"valid loss:{vm['total_loss']:.6f}"
            print(vline)
            log_fp.write(vline + "\n")
            for k, v in vm.items():
                summary.add_scalar(f"validation/{k}", v, global_step)

    def run_train_interface_dist(self, backend: Optional[str] = None, **kwargs) -> TrainState:
        """Data-parallel training, one process a rank (the reference's DDP path,
        interface_physics.py:848-1404): joins the process group of ``torchrun``'s environment
        (``parallel/multihost.py``; ``backend`` NCCL unless named, gloo for ranks on the CPU or sharing
        a card), moves this interface to the rank's device, and runs ``run_train_interface(dist=True)``.
        Each rank loads its data slot's windows; rank 0 logs and saves."""
        self.device = multihost.initialize_distributed(backend, device="cpu" if self.device.type == "cpu" else None)
        return self.run_train_interface(dist=True, **kwargs)

    _MAX_CONSECUTIVE_VALID_FAILURES = 3

    def _valid_windows_cap(self, valid_dataset, floor: int = 1) -> int:
        """How many valid windows the device-mode validation rotates over: ``tpu.valid_windows``
        (8), each window's cube cached on the device, so that after the first round a validation
        reads nothing from the host."""
        cap = int(self.train_cfg.get("tpu", {}).get("valid_windows", 8))
        return min(len(valid_dataset), max(floor, cap))

    @staticmethod
    def _valid_scfg(scfg, valid_dataset):
        """The valid split's own point counts (its label_batch_size and batch_size_inter)."""
        return dataclasses.replace(scfg, n_margin=valid_dataset.label_batch_size,
                                   n_inter=valid_dataset.inter_batch_size)

    def _device_valid_cube(self, valid_dataset, idx, cap, scfg_v=None, cfg=None):
        """Valid window ``idx`` on the device, from an LRU of ``cap`` windows; under
        ``ds_sampler='pool'`` with its pool, as the training loop's cubes."""
        if not hasattr(self, "_valid_cubes"):
            self._valid_cubes = ds.DeviceLRU(cap)
        use_pool = self.ds_sampler == "pool" and scfg_v is not None

        def build():
            cube = ds.cube_batch_from_items(
                [valid_dataset.get_cube_item(idx)], pool_pad=scfg_v.n_margin if use_pool else None,
                keep_label_cube=not use_pool,
                expect_dims=(ds.expected_cube_dims(scfg_v, cfg.coord_spec)
                             if scfg_v is not None and cfg is not None else None))
            cube = ds.cube_to_device(cube, self.device)
            return ds.attach_pool_nwp(cube, scfg_v, cfg.coord_spec) if use_pool else cube

        return self._valid_cubes.get(idx, build)

    def _device_mode_validation(self, valid_dataset, cfg, scfg, state, with_pde, fetch: bool = True):
        """One device-sampled validation window: its points drawn on the device from a generator
        seeded 7919 at each call, so that repeated validations score the same points; rotation over
        ``_valid_windows_cap`` cached windows; the valid split's point counts.  ``fetch=False``
        returns the metrics as device tensors.  A failure is reported and skipped, three in a row
        fail the run (``valid_failures`` counts them all)."""
        try:
            if not hasattr(self, "_valid_eval_step"):
                self._valid_eval_step = ds.make_device_sampling_eval_step(cfg, self._valid_scfg(scfg, valid_dataset))
                self._valid_item = 0
                self._valid_failures = 0
                self._n_valid_rot = self._valid_windows_cap(valid_dataset)
            idx = self._valid_item % self._n_valid_rot
            self._valid_item += 1
            scfg_v = self._valid_scfg(scfg, valid_dataset)
            cube = self._device_valid_cube(valid_dataset, idx, self._n_valid_rot, scfg_v=scfg_v, cfg=cfg)
            generator = torch.Generator(device=self.device).manual_seed(7919)
            draws = ds.draw_points(generator, cube.field.shape[0], scfg_v, cfg.coord_spec)
            out = self._valid_eval_step(state.model, cube, draws, with_pde)
            if fetch:
                out = self._fetch_metrics(out)
            self._valid_failures = 0
            return out
        except Exception as e:
            self._valid_failures = getattr(self, "_valid_failures", 0) + 1
            self.valid_failures += 1
            if self._valid_failures >= self._MAX_CONSECUTIVE_VALID_FAILURES:
                raise RuntimeError(f"device-mode validation failed {self._valid_failures} times in a row; "
                                   "failing the run") from e
            print(f"warning: device-mode validation failed ({e}); "
                  f"{self._valid_failures}/{self._MAX_CONSECUTIVE_VALID_FAILURES}")
            return None

    def _device_mode_validation_dist(self, valid_dataset, cfg, scfg, state, with_pde, mesh):
        """A validation of the data-parallel device-sampled loop, a collective: each data slot scores its
        window of the rotation (``_valid_windows_cap``, at least one a slot), its points the slot's rows of
        the draws of a generator seeded 7919 for ``mesh.data`` windows, the metrics averaged over every
        rank.  No failure is skipped: a rank that left a collective would strand the others."""
        if not hasattr(self, "_valid_sharded_step"):
            self._valid_sharded_step = sharding.make_sharded_device_sampling_eval_step(
                cfg, mesh, self._valid_scfg(scfg, valid_dataset))
            self._valid_item = 0
            self._n_valid_rot = self._valid_windows_cap(valid_dataset, floor=mesh.data)
            self._valid_dist_cubes = ds.DeviceLRU(self._n_valid_rot)
        idx = (self._valid_item + mesh.data_index) % self._n_valid_rot
        self._valid_item += mesh.data
        scfg_v = self._valid_scfg(scfg, valid_dataset)
        use_pool = self.ds_sampler == "pool"

        def build():
            cube = ds.cube_batch_from_items(
                [valid_dataset.get_cube_item(idx)], pool_pad=scfg_v.n_margin if use_pool else None,
                keep_label_cube=not use_pool, expect_dims=ds.expected_cube_dims(scfg_v, cfg.coord_spec))
            cube = ds.cube_to_device(cube, self.device)
            return ds.attach_pool_nwp(cube, scfg_v, cfg.coord_spec) if use_pool else cube

        cube = self._valid_dist_cubes.get(idx, build)
        generator = torch.Generator(device=self.device).manual_seed(7919)
        draws = ds.draw_points(generator, mesh.data, scfg_v, cfg.coord_spec)
        return self._valid_sharded_step(state.model, cube, draws, with_pde)

    @staticmethod
    def _install_preemption_handler(flag: dict):
        """SIGTERM -> ``flag["flag"] = True`` (the loop finishes the step, checkpoints, stops); returns
        the handler it replaced (None off the main thread, where no handler is installed)."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def handler(signum, frame):
            flag["flag"] = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            return None

    @staticmethod
    def _restore_preemption_handler(previous) -> None:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)

    def _agreed_preemption(self, preempted: dict, nproc: int = 1, global_step: int = 0, check_every: int = 20) -> bool:
        """Whether every rank stops now: SIGTERM reaches each process alone, and a rank that stopped
        while another entered the next collective would strand it.  With several ranks the flag is
        all-reduced (max) every ``check_every`` steps (``train_cfg.tpu.preempt_check_step``), a
        condition on ``global_step`` alone, which every rank shares; one process reads its flag."""
        if nproc <= 1:
            return bool(preempted["flag"])
        if check_every > 1 and global_step % check_every != 0:
            return False
        return multihost.all_ranks_max(bool(preempted["flag"]), self.device)

    @staticmethod
    def _drain_async_ckpt(async_ckpt) -> None:
        """Wait for in-flight async saves; a PRIOR save's failure is reported but never prevents the
        synchronous save that follows."""
        if async_ckpt is None:
            return
        try:
            async_ckpt.wait()
        except Exception as e:
            print(f"warning: an earlier async checkpoint save failed ({e}); proceeding with the synchronous save")

    def _epoch_save(self, async_ckpt, is_last, checkpoint_path, epoch, global_step, state, meta_kwargs) -> None:
        """Epoch-boundary checkpoint: off the loop's thread mid-run, synchronous for the final epoch
        (returning implies a durable physics_latest)."""
        if async_ckpt is not None and not is_last:
            async_ckpt.submit(checkpoint_path, epoch, global_step, state.model, state.optimizer, prefix="physics",
                              **meta_kwargs)
            return
        self._drain_async_ckpt(async_ckpt)
        ckpt.save_checkpoint(checkpoint_path, epoch, global_step, state.model, state.optimizer, prefix="physics",
                             **meta_kwargs)

    def _preemption_save(self, async_ckpt, checkpoint_path, epoch, global_step, state, **meta_kwargs) -> None:
        """One synchronous save inside the SIGTERM grace window, with the metadata bundle."""
        self._drain_async_ckpt(async_ckpt)
        print(f"preemption: saving checkpoint at step {global_step}")
        ckpt.save_checkpoint(checkpoint_path, epoch, global_step, state.model, state.optimizer, prefix="physics",
                             **meta_kwargs)

    def _render_grid(self, model, dataset, data, cfg, out_dir, global_step, with_pde) -> None:
        """Full-grid render of all six variables (reference interface_physics.py:532-606)."""
        from deepphysinet_tpu_torch.inference.runner import predict_grid
        from deepphysinet_tpu_torch.utils.vis import VisUtils

        time_id = (int(np.random.randint(0, dataset.input_time_step * dataset.input_time_step_nums + 1))
                   if with_pde else 0)
        input_file = data["input_file"][0]
        fh = float(np.asarray(data["forecast_h"]).reshape(-1)[0])
        window = Window.from_dataset(dataset, input_file, labels=False)
        grids = predict_grid(model, cfg, window, np.asarray(data["field_data"][0:1], np.float32), fh, time_id,
                             with_clip=False, device=self.device)
        vis = VisUtils(coord_file=None, landsea_file=os.path.join(dataset.constant_path, "landsea.tiff"))
        for name, img in grids.items():
            out = os.path.join(out_dir, f"{global_step}_result_{name}_f{int(fh):03d}.jpg")
            vis.forward(img, out, title=f"{name} f{int(fh):03d} t+{time_id}h")

    # ---- evaluation ----

    def load_physics_net(self, checkpoint_path: Optional[str] = None):
        """``(model, epoch, global_step)``: the configuration's ``PhysicsNet`` on the run's device in
        eval mode, with the weights of the checkpoint at ``checkpoint_path`` (default
        ``train_cfg.checkpoints.checkpoints_path``; the port's ``.pth``, a reference ``.pth`` or a JAX
        pickle, ``train/checkpoint.py``); ``epoch`` is the checkpoint's next epoch."""
        ckpt_path = checkpoint_path or self.train_cfg["checkpoints"]["checkpoints_path"]
        payload, epoch, step = ckpt.load_checkpoint(ckpt_path, prefix="physics")
        if payload is None:
            raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
        model = PhysicsNet(self.meta_cfg, self.net_cfg, compute_dtype=self.compute_dtype, device=self.device,
                           attn_impl=self.attn_impl)
        model.load_state_dict(payload["model"], strict=True)
        model.eval()
        return model, epoch, step

    def run_test_interface(self, checkpoint_path: Optional[str] = None, max_windows: Optional[int] = None,
                           full_grid: bool = True, **kwargs) -> Dict[str, float]:
        """Held-out RMSE of a checkpoint over ``test_cfg.test_data`` (when it names a dataset) or
        ``train_cfg.valid_data``: every labelled grid point at every labelled hour
        (``full_grid=True``, ``evaluate_rmse_fullgrid``), or the subsampled estimate
        (``evaluate_rmse``, which takes ``kwargs``).  Writes ``test_cfg.log.result_file`` when set."""
        from deepphysinet_tpu_torch.eval.rmse import evaluate_rmse, evaluate_rmse_fullgrid

        tc = self.train_cfg
        self.dx = float(tc["dx"])
        self.dy = float(tc["dy"])
        model, epoch, step = self.load_physics_net(
            checkpoint_path or self.test_cfg.get("checkpoints", {}).get("checkpoints_path"))

        data_cfg = self.test_cfg.get("test_data")
        if not (isinstance(data_cfg, dict) and data_cfg.get("input_path")):
            data_cfg = tc["valid_data"]
        dataset = self._dataset(data_cfg)
        window_h = dataset.input_time_step * dataset.input_time_step_nums
        cfg = self._step_cfg(float(window_h * 3600), dataset.forecast_time_period)
        if full_grid:
            metrics = evaluate_rmse_fullgrid(model, cfg, DatasetWindows(dataset), max_windows=max_windows,
                                             device=self.device)
        else:
            metrics = evaluate_rmse(model, cfg, dataset, max_windows=max_windows, device=self.device, **kwargs)
        metrics["epoch"] = float(epoch - 1)
        metrics["global_step"] = float(step)
        result_file = self.test_cfg.get("log", {}).get("result_file")
        if result_file:
            import json

            os.makedirs(os.path.dirname(os.path.abspath(result_file)), exist_ok=True)
            with open(result_file, "w") as fp:
                json.dump(metrics, fp, indent=2)
        return metrics

    # ---- inference ----

    def run_inference_interface(self, checkpoint_path: Optional[str] = None, **kwargs):
        """``inference/runner.py::run_inference`` on this configuration and device."""
        from deepphysinet_tpu_torch.inference.runner import run_inference

        return run_inference(self._config(), checkpoint_path=checkpoint_path, device=self.device)
