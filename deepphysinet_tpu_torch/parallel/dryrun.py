"""Rehearse the data-parallel steps in spawned ranks: ``dryrun_multigpu(n)``.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: where JAX jits one sharded step over a
virtual mesh of n CPU devices, the port starts n processes (``launch``, the environment ``torchrun``
would give them: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) that each
run the sharded steps of ``parallel/sharding.py`` on their block (``run_spec``):

* the host-sampled PDE step under ``'kernel'`` and ``'jvp'`` on a (n, 1) mesh;
* the device-sampled PDE step with the iid and the pool sampler on (n, 1);
* the device-sampled step with either sampler on a (n/2, 2) mesh (n even).

Each case checks that the loss is finite and that every rank holds the same one.  On a node with n
cards the ranks take one each over NCCL; ``--device cpu`` runs them on the CPU over gloo; with fewer
cards than ranks gloo shares them (``parallel/multihost.py``).  Run

    python -m deepphysinet_tpu_torch.parallel.dryrun --n 2 [--device cpu] [--backend gloo]

``run_spec`` serves the tests and ``chip_smoke.py`` too: a spec file (``torch.save`` of a dict) names
the model, its starting weights and optimizer state (or a checkpoint to resume from), and the cases
(a global host batch or cube and the global draws, a mesh, the step's configuration); each rank writes
its metrics, its launch counts and (rank 0) its final state to ``{out}/rank{r}.pt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deepphysinet_tpu_torch.parallel import multihost
from deepphysinet_tpu_torch.parallel.mesh import MeshConfig, make_mesh, shard_batch
from deepphysinet_tpu_torch.parallel import sharding


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n: int, argv: Sequence[str], timeout: float = 600.0,
           module: str = "deepphysinet_tpu_torch.parallel.dryrun") -> List[str]:
    """Run ``python -m {module} *argv`` as ranks 0..n-1 of one group on this node (``torchrun``'s
    environment, a free port on localhost); returns each rank's output.  Raises, with the outputs' ends,
    when a rank fails; every rank is stopped before this returns."""
    base = dict(os.environ)
    base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    procs, logs = [], []
    try:
        for r in range(n):  # each rank's output to a file: a full pipe would block a rank inside a collective
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=dict(base, RANK=str(r),
                                          LOCAL_RANK=str(r)), stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("ranks %s failed:\n%s" % (bad, "\n".join(f"--- rank {r}:\n{outs[r][-3000:]}" for r in bad)))
    return outs


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from deepphysinet_tpu_torch.ops import attention, decode_kernel, encoder_kernel, residual_kernel

    out = {}
    for mod in (decode_kernel, residual_kernel, attention, encoder_kernel):
        for name, f in vars(mod).items():
            if callable(f) and isinstance(getattr(f, "launches", None), int):
                out[name] = f.launches
    return out


def _cube_rows(cube, mesh):
    """This rank's data slot's windows of a global host ``CubeBatch`` (every leaf split on axis 0)."""
    def rows(a):
        if a is None:
            return None
        k = a.shape[0] // mesh.data
        return a[mesh.data_index * k:(mesh.data_index + 1) * k]

    return type(cube)(*map(rows, cube))


def _state(spec, device, compute_dtype: str):
    """The spec's model and optimizer on ``device``: its weights and optimizer state, or the
    checkpoint it names, through the trainer's resume (``restore_train_state``)."""
    from deepphysinet_tpu_torch.train import checkpoint as ckpt
    from deepphysinet_tpu_torch.train.train_step import create_train_state

    state = create_train_state(spec["meta"], spec["net"], spec["opt"], torch.Generator().manual_seed(0),
                               compute_dtype=getattr(torch, compute_dtype), device=device)
    if spec.get("checkpoint"):
        payload, _, step = ckpt.load_checkpoint(spec["checkpoint"], prefix="physics")
        ckpt.restore_train_state(state, payload, False)
        state.step = step
    else:
        state.model.load_state_dict(spec["model_state"])
        if spec.get("optim_state") is not None:
            state.optimizer.load_state_dict(spec["optim_state"])
    return state


def run_case(case: dict, spec: dict, device) -> dict:
    """One sharded step of ``case`` from the spec's starting state on this rank (in the case's
    ``compute_dtype``, else the spec's); its metrics (floats), the launches it made, its host-clock
    seconds and the state it ends in."""
    import time

    from deepphysinet_tpu_torch.train import device_sampling as ds
    from deepphysinet_tpu_torch.train.train_step import batch_to_device

    state = _state(spec, device, case.get("compute_dtype", spec.get("compute_dtype", "float32")))
    mesh = make_mesh(MeshConfig(*case["mesh"]))
    before = launch_counts()
    t0 = time.perf_counter()
    if case["kind"] == "host":
        step = sharding.make_sharded_train_step(case["cfg"], mesh)
        state, metrics = step(state, shard_batch(batch_to_device(case["batch"], device=device), mesh), case["with_pde"])
    else:
        scfg, coord_spec = case["scfg"], case["cfg"].coord_spec
        cube = ds.cube_to_device(_cube_rows(case["cube"], mesh), device)
        if cube.pool_rows is not None:
            cube = ds.attach_pool_nwp(cube, scfg, coord_spec)
        draws = ds.Draws(*(a.to(device) for a in case["draws"]))
        step = sharding.make_sharded_device_sampling_step(case["cfg"], mesh, scfg)
        state, metrics = step(state, cube, draws, case["with_pde"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    return dict(metrics={k: float(v) for k, v in metrics.items()}, state=state, seconds=seconds,
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]})


def reduce_ms(state, device, repeats: int) -> list:
    """Host-clock milliseconds of ``repeats`` averagings of a buffer of the model's gradients' size
    (``sharding.mean_over_ranks_``), each after a barrier."""
    import time

    buf = [torch.ones_like(p) for p in state.model.parameters()]
    out = []
    for _ in range(repeats):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        sharding.mean_over_ranks_(buf)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_spec(spec_path: str, out_dir: str, backend: Optional[str] = None, device=None) -> None:
    """A rank's side: join the group, run every case of the spec, write ``{out_dir}/rank{r}.pt``
    (rank 0 also each case's final parameters and optimizer state, and a checkpoint of the last case
    into ``spec["save_dir"]`` when it names one)."""
    dev = multihost.initialize_distributed(backend, device=device)
    try:
        spec = torch.load(spec_path, weights_only=False)
        if spec.get("tf32") is False and dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        r = multihost.rank()
        results, extra = {}, {}
        for case in spec["cases"]:
            out = run_case(case, spec, dev)
            state = out.pop("state")
            if spec.get("time_reduce") and case is spec["cases"][-1]:
                extra = dict(reduce_ms=[round(t, 3) for t in reduce_ms(state, dev, spec["time_reduce"])],
                             reduce_bytes=4 * sum(p.numel() for p in state.model.parameters()))
            if r == 0:
                out["params"] = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
                out["optim_state"] = state.optimizer.state_dict()
                if spec.get("save_dir") and case is spec["cases"][-1]:
                    from deepphysinet_tpu_torch.train import checkpoint as ckpt

                    ckpt.save_checkpoint(spec["save_dir"], 0, state.step, state.model, state.optimizer,
                                         prefix="physics")
            results[case["name"]] = out
        os.makedirs(out_dir, exist_ok=True)
        torch.save(dict(rank=r, world=multihost.world_size(), device=str(dev), results=results, **extra),
                   os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def read_results(out_dir: str, n: int) -> List[dict]:
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(n)]


# ---- the dry run -------------------------------------------------------------------------------------------

META = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32, activation="gelu",
            learnable_token_num=8)
NET = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)
OBS_CFG = {
    "u10": dict(name="u10", norm_factor=[0.1, 3.0], bound=[-500, 500]),
    "v10": dict(name="v10", norm_factor=[-0.1, 3.0], bound=[-500, 500]),
    "pres": dict(name="PSFC", norm_factor=[89741.0, 13296.0], bound=[10000, 500000]),
    "t2": dict(name="t2", norm_factor=[283.5, 15.5], bound=[50, 500]),
    "q2": dict(name="q2", norm_factor=[0.0079, 0.0063], bound=[1e-6, 10]),
    "rio": dict(name="rio", norm_factor=[1.09, 0.15], bound=[1e-6, 10]),
}
FACTORS = dict(sample_factor=1e6, margin_factor=1e6, motion_u_factor=1e3, motion_v_factor=1e3,
               continuous_factor=1e10, energy_factor=1e1, vapor_factor=1e14, gas_factor=1e-7)
OPT = dict(name="Adam", lr=1e-4, weight_decay=1e-4)


def tiny_spec(n: int, seed: int = 0) -> dict:
    """The dry run's model (the tests' tiny widths), a global batch of ``n`` windows, cubes of the
    smoke box (37 x 65 labels) and the step's draws, with the cases of the module docstring."""
    from deepphysinet_tpu_torch.ops.coords import CoordSpec
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
    from deepphysinet_tpu_torch.train import device_sampling as ds
    from deepphysinet_tpu_torch.train.train_step import StepConfig, create_train_state

    rng = np.random.RandomState(seed)
    specs = norm_specs_from_cfg(OBS_CFG)
    cfg = StepConfig(coord_spec=CoordSpec(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0),
                     obs_specs=tuple(specs[k] for k in OBS_NAME_ORDER), loss_factor=FACTORS, pde_engine="kernel")
    state = create_train_state(META, NET, OPT, torch.Generator().manual_seed(seed), device="cpu")

    def pts(b, n_pts):
        return dict(x=(rng.rand(b, n_pts) * 27000 * 256).astype(np.float32),
                    y=(rng.rand(b, n_pts) * 27000 * 144).astype(np.float32),
                    t=(rng.randint(0, 25, (b, n_pts)) * 3600.0).astype(np.float32),
                    f=(rng.rand(b, n_pts, 1) * 1e-4).astype(np.float32),
                    nwp=(rng.randn(b, n_pts, 6) * 0.1).astype(np.float32),
                    labels=(rng.randn(b, n_pts, 6) * 0.1).astype(np.float32))

    batch = dict(field=rng.randn(n, 12, 65).astype(np.float32), forecast_h=np.full(n, 24.0, np.float32),
                 margin=pts(n, 16), inter=pts(n, 8))
    scfg = ds.SamplerConfig(n_margin=16, n_inter=8, window_h=24, input_time_step=6)
    ds_cfg = dataclasses.replace(cfg, coord_spec=dataclasses.replace(cfg.coord_spec, lon_size=65, lat_size=37))
    nwp = (rng.randn(n, 6, 10, 17, 5) * 0.1).astype(np.float32)
    label = (rng.randn(n, 6, 37, 65, 25) * 0.1).astype(np.float32)
    field = rng.randn(n, 12, 65).astype(np.float32)
    fh = np.full(n, 24.0, np.float32)
    cubes = {"iid": ds.cube_batch_host(field, fh, nwp, label),
             "pool": ds.cube_batch_host(field, fh, nwp, label, pool_pad=scfg.n_margin, pool_seeds=list(range(n)),
                                        keep_label_cube=False)}
    generator = torch.Generator().manual_seed(seed + 1)
    cases = [dict(name=f"host {engine}", kind="host", mesh=(n, 1), batch=batch, with_pde=True,
                  cfg=dataclasses.replace(cfg, pde_engine=engine)) for engine in ("kernel", "jvp")]
    for sampler, cube in cubes.items():
        draws = ds.draw_points(generator, n, scfg, ds_cfg.coord_spec)
        cases.append(dict(name=f"device {sampler}", kind="device", mesh=(n, 1), cube=cube, draws=draws, scfg=scfg,
                          cfg=ds_cfg, with_pde=True))
        if n % 2 == 0 and n > 1:
            half = n // 2
            draws2 = ds.draw_points(generator, half, scfg, ds_cfg.coord_spec)
            cases.append(dict(name=f"device {sampler} {half}x2", kind="device", mesh=(half, 2),
                              cube=type(cube)(*(None if a is None else a[:a.shape[0] // n * half] for a in cube)),
                              draws=draws2, scfg=scfg, cfg=ds_cfg, with_pde=True))
    return dict(meta=META, net=NET, opt=OPT, compute_dtype="float32", model_state=state.model.state_dict(),
                optim_state=None, cases=cases)


def dryrun_multigpu(n: int, device: Optional[str] = None, backend: Optional[str] = None,
                    timeout: float = 600.0) -> Dict[str, List[float]]:
    """Run the dry run's cases in ``n`` spawned ranks; returns each case's total loss on every rank.
    Raises when a loss is not finite or the ranks disagree."""
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' to rehearse the ranks on the CPU (gloo)")
        backend = backend or ("nccl" if n <= cards else "gloo")
    else:
        backend = backend or "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.pt")
        torch.save(tiny_spec(n), spec_path)
        argv = ["--child", spec_path, os.path.join(tmp, "out"), "--backend", backend]
        launch(n, argv + (["--device", device] if device else []), timeout=timeout)
        ranks = read_results(os.path.join(tmp, "out"), n)
    losses = {}
    for name in ranks[0]["results"]:
        vals = [rk["results"][name]["metrics"]["total_loss"] for rk in ranks]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"dryrun_multigpu({n}): non-finite loss in {name}: {vals}")
        if len(set(vals)) != 1:
            raise AssertionError(f"dryrun_multigpu({n}): the ranks disagree on {name}: {vals}")
        print(f"dryrun_multigpu({n}): {name}: total_loss={vals[0]:.6e} on {n} ranks ({backend}, "
              f"{ranks[0]['device']}) OK")
        losses[name] = vals
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("the port's data-parallel dry run")
    parser.add_argument("--n", type=int, default=2)
    parser.add_argument("--device", type=str, default=None, help="cpu: ranks on the CPU over gloo")
    parser.add_argument("--backend", type=str, default=None)
    parser.add_argument("--child", nargs=2, metavar=("SPEC", "OUT"), default=None,
                        help="run as one rank of a launch (set by launch)")
    args = parser.parse_args(argv)
    if args.child:
        torch.set_num_threads(1)
        run_spec(args.child[0], args.child[1], backend=args.backend, device=args.device)
        return 0
    dryrun_multigpu(args.n, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
