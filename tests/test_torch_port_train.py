"""PyTorch port against the JAX package: the training step as a whole.

At the tiny dims of tests/test_train_step.py, in float32, the same weights
(JAX init, carried over with ``load_train_state``) and the same ``Batch`` (numpy,
from a seed) go through the JAX step -- ``make_train_step`` with
``pde_engine='kernel'``, ``kernel_interpret=True``, ``kernel_version=7``, i.e. the
real Pallas kernels in interpret mode -- and through the port's step with its
``'kernel'`` engine, whose wrappers take their plain versions on CPU tensors.
Three steps each, data-only and with the PDE terms.  The same again, with the PDE
terms, for the step's other routes: ``kernel_version=4`` in both layouts (the
v4t and the ``[N, 6]`` v4 Pallas pairs in interpret mode against the port's
plain versions), ``kernel_version=6`` under ``'kernel'`` (the v6 Pallas pair in
interpret mode) and ``'jvp'`` (the XLA twin), packed and dict assembly, the
``'linearize'`` engine (``jax.linearize`` against
``torch.func.jvp``) and a PDE criterion other than MSE (the dict-form assembly).

Tolerances.  Every metric of every step: rtol 1e-4 (float32 matmul chains in
another summation order; the loss factors span 1e-7..1e14 but each metric is
compared relative to itself).  Parameters after three Adam steps at lr 1e-4:
each step moves an entry by ``lr * m / (sqrt(v) + eps)``, about lr whatever the
gradient's size, so three steps move every entry by 3e-4, and a relative
gradient difference d between the packages moves it by about ``lr * d``.  The
bound is absolute, 3 steps * lr * 2e-2 = 6e-6 (measured: 1e-7).  Adam also
turns a gradient that is pure rounding noise into full steps of either sign.
That is so for the whole key-projection bias (softmax is invariant to it, its
exact gradient is zero) and for a few isolated entries elsewhere; such entries
may differ by up to 2 * 3 * lr, and fewer than one entry in 10,000 outside the
key bias may do so.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer

from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.train import train_step as tts
from deepphysinet_tpu_torch.train.torch_import import load_train_state, state_dict_from_jax

META = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32,
            activation="gelu", learnable_token_num=8)
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
COORD = dict(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
OPT = dict(name="Adam", lr=1e-4, weight_decay=1e-4)  # the flagship configuration's optimizer
STEPS = 3
METRIC_RTOL = 1e-4
PARAM_ATOL = 6e-6


def _numpy_batch(seed=0, B=2, L=12, Nm=32, Ni=16):
    rng = np.random.RandomState(seed)

    def pts(n):
        return dict(
            x=(rng.rand(B, n) * 27000 * 256).astype(np.float32),
            y=(rng.rand(B, n) * 27000 * 144).astype(np.float32),
            t=(rng.randint(0, 25, (B, n)) * 3600.0).astype(np.float32),
            f=(rng.rand(B, n, 1) * 1e-4).astype(np.float32),
            nwp=(rng.randn(B, n, 6) * 0.1).astype(np.float32),
            labels=(rng.randn(B, n, 6) * 0.1).astype(np.float32))

    return dict(field=rng.randn(B, L, 65).astype(np.float32),
                forecast_h=np.array([24.0, 30.0][:B], np.float32), margin=pts(Nm), inter=pts(Ni))


def _jax_batch(nb):
    def pts(d):
        return jts.PointBatch(**{k: jnp.asarray(v) for k, v in d.items()})

    return jts.Batch(field=jnp.asarray(nb["field"]), forecast_h=jnp.asarray(nb["forecast_h"]),
                     margin=pts(nb["margin"]), inter=pts(nb["inter"]))


def _adam_state(opt_state):
    """(count, mu, nu) of the optax ``ScaleByAdamState`` inside the injected chain."""
    (adam,) = [s for s in opt_state.inner_state if hasattr(s, "mu")]
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return int(adam.count), to_np(adam.mu), to_np(adam.nu)


def _snapshot(state):
    return dict(step=int(state.step), params=jax.tree.map(np.asarray, state.params),
                adam=_adam_state(state.opt_state))


@pytest.fixture(scope="module")
def world():
    """Both packages' configs, the batch, and the JAX trajectories (3 steps each)."""
    jspecs, tspecs = j_norm_specs(OBS_CFG), norm_specs_from_cfg(OBS_CFG)
    jcfg = jts.StepConfig(coord_spec=JaxCoordSpec(**COORD), obs_specs=tuple(jspecs[k] for k in J_ORDER),
                          loss_factor=FACTORS, pde_engine="kernel", kernel_interpret=True,
                          kernel_version=7)
    tcfg = tts.StepConfig(coord_spec=CoordSpec(**COORD), obs_specs=tuple(tspecs[k] for k in OBS_NAME_ORDER),
                          loss_factor=FACTORS)
    assert tcfg.pde_engine == "kernel"
    nb = _numpy_batch()
    jbatch = _jax_batch(nb)
    jmodel = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    tx = j_build_optimizer(**OPT)
    jstep = jts.make_train_step(jmodel, tx, jcfg)

    def jax_run(with_pde):
        state = jts.create_train_state(jmodel, tx, jax.random.PRNGKey(0), jbatch)
        snaps, metrics = [_snapshot(state)], []
        for _ in range(STEPS):
            state, m = jstep(state, jbatch, with_pde=with_pde)
            metrics.append({k: float(v) for k, v in m.items()})
            snaps.append(_snapshot(state))
        return snaps, metrics

    return dict(tcfg=tcfg, nb=nb, jax={False: jax_run(False), True: jax_run(True)})


def _port_state(snap):
    state = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), device="cpu")
    count, mu, nu = snap["adam"]
    return load_train_state(state, snap["params"], mu, nu, count, snap["step"])


def _port_run(world, with_pde, start=0):
    state = _port_state(world["jax"][with_pde][0][start])
    step = tts.make_train_step(world["tcfg"])
    batch = tts.batch_to_device(world["nb"], device="cpu")
    metrics = []
    for _ in range(STEPS - start):
        state, m = step(state, batch, with_pde)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_metrics_close(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        assert np.isfinite(got[k]), (where, k)
        np.testing.assert_allclose(got[k], w, rtol=METRIC_RTOL, atol=1e-12, err_msg=f"{where} {k}")


def _assert_params_close(model, jax_params, steps=STEPS):
    want = state_dict_from_jax(jax_params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    reach = 2 * steps * OPT["lr"] * 1.01  # what Adam can put between two runs
    off = total = 0
    for k, w in want.items():
        diff = np.abs(got[k].numpy() - w.numpy())
        assert diff.max() <= reach, (k, diff.max())
        if not k.endswith("key_projection.bias"):
            off += int((diff > PARAM_ATOL).sum())
            total += diff.size
    assert off <= 1e-4 * total, (off, total)


@pytest.mark.parametrize("with_pde", [False, True], ids=["data_only", "pde"])
def test_three_step_metrics_match_jax(world, with_pde):
    _, jmetrics = world["jax"][with_pde]
    state, tmetrics = _port_run(world, with_pde)
    assert state.step == STEPS
    for i in range(STEPS):
        _assert_metrics_close(tmetrics[i], jmetrics[i], f"step {i}")
    assert tmetrics[0]["skipped_nonfinite"] == 0.0
    if with_pde:
        assert {"inter_total", "margin_total", "inter_vapor_loss", "margin_gas_loss"} <= set(tmetrics[0])


@pytest.mark.parametrize("with_pde", [False, True], ids=["data_only", "pde"])
def test_parameters_after_three_steps_match_jax(world, with_pde):
    snaps, _ = world["jax"][with_pde]
    state, _ = _port_run(world, with_pde)
    _assert_params_close(state.model, snaps[STEPS]["params"])
    # and they did move: the comparison is not between two untouched copies
    start = state_dict_from_jax(snaps[0]["params"])
    moved = [float((state.model.state_dict()[k] - v).abs().max()) for k, v in start.items()]
    assert min(moved) > 10 * PARAM_ATOL


def test_train_state_carried_across_and_continued(world):
    """Two PDE steps in JAX, the state carried over, the third step in both."""
    snaps, jmetrics = world["jax"][True]
    state = _port_state(snaps[2])
    assert state.step == 2
    count, mu, _ = snaps[2]["adam"]
    assert count == 2
    for p in state.optimizer.state.values():
        assert float(p["step"]) == 2.0
    name, param = next(iter(state.model.named_parameters()))
    np.testing.assert_array_equal(state.optimizer.state[param]["exp_avg"].numpy(),
                                  state_dict_from_jax(mu)[name].numpy())
    state, tmetrics = _port_run(world, True, start=2)
    assert state.step == 3
    _assert_metrics_close(tmetrics[0], jmetrics[2], "step 2 after carry-over")
    _assert_params_close(state.model, snaps[3]["params"], steps=1)


def test_nonfinite_guard_leaves_parameters_and_moments_untouched(world):
    snaps, _ = world["jax"][False]
    state = _port_state(snaps[1])  # after one step, so that Adam has moments
    step = tts.make_train_step(world["tcfg"])
    nb = world["nb"]
    bad = dict(nb, margin=dict(nb["margin"], labels=nb["margin"]["labels"].copy()))
    bad["margin"]["labels"][0, 0, 0] = np.nan
    params_before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments_before = {k: {n: t.clone() for n, t in s.items()} for k, s in state.optimizer.state.items()}
    for with_pde in (False, True):
        state, m = step(state, tts.batch_to_device(bad, device="cpu"), with_pde)
        assert float(m["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert state.step == 3  # the batches count, as in the JAX step
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params_before[k]), k
    for p, s in state.optimizer.state.items():
        for n, t in s.items():
            assert torch.equal(t, moments_before[p][n]), n
    # a clean batch afterwards trains normally
    state, m = step(state, tts.batch_to_device(nb, device="cpu"), False)
    assert float(m["skipped_nonfinite"]) == 0.0 and np.isfinite(float(m["total_loss"]))
    assert not torch.equal(next(iter(state.model.parameters())), next(iter(params_before.values())))


def test_jvp_engine_is_the_plain_version_of_the_kernel_engine(world):
    """On the CPU both engines run the same arithmetic forward; the gradients come
    from autograd ('jvp') and from the hand-derived backward ('kernel')."""
    snaps, _ = world["jax"][True]
    batch = tts.batch_to_device(world["nb"], device="cpu")
    out = {}
    for engine in ("kernel", "jvp"):
        state = _port_state(snaps[0])
        cfg = dataclasses.replace(world["tcfg"], pde_engine=engine)
        total, (metrics, _) = tts.make_loss_fn(state.model, cfg)(batch, True)
        total.backward()
        out[engine] = ({k: float(v.detach()) for k, v in metrics.items()},
                       {k: p.grad.clone() for k, p in state.model.named_parameters()})
    for k, v in out["kernel"][0].items():
        assert out["jvp"][0][k] == v, k
    gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in out["jvp"][1].values()])))
    for k, g in out["kernel"][1].items():
        np.testing.assert_allclose(g.numpy(), out["jvp"][1][k].numpy(), rtol=1e-4, atol=1e-6 * gnorm,
                                   err_msg=k)


def test_eval_step_makes_no_update_and_reports_the_step_losses(world):
    snaps, jmetrics = world["jax"][True]
    state = _port_state(snaps[0])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = tts.make_eval_step(world["tcfg"])(state.model, tts.batch_to_device(world["nb"], device="cpu"), True)
    for k, v in m.items():  # the losses of step 0, before its update
        np.testing.assert_allclose(float(v), jmetrics[0][k], rtol=METRIC_RTOL, err_msg=k)
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert all(p.grad is None for p in state.model.parameters())


def test_unported_options_raise(world):
    tcfg = world["tcfg"]
    with pytest.raises(ValueError, match="unknown pde_engine"):
        tts.make_train_step(dataclasses.replace(tcfg, pde_engine="pallas"))
    # kernel_version 2 (the uncollapsed decode) is the one generation of the step still to port
    with pytest.raises(NotImplementedError, match="kernel_version=2.*ROADMAP B8"):
        tts.step_config_from_cfg(dict(train_cfg=dict(tpu=dict(kernel_version=2))))
    with pytest.raises(NotImplementedError, match="kernel_version=2.*ROADMAP B8"):
        tts.make_eval_step(dataclasses.replace(tcfg, kernel_version=2))
    with pytest.raises(NotImplementedError, match="kernel_version=2.*ROADMAP B8"):
        tts.make_train_step(dataclasses.replace(tcfg, kernel_version=2))
    with pytest.raises(KeyError, match="NoSuchLoss"):
        tts.make_eval_step(dataclasses.replace(tcfg, pde_loss="NoSuchLoss"))(
            None, tts.batch_to_device(world["nb"], device="cpu"), True)


# the step's other routes: (JAX StepConfig fields, port StepConfig fields)
VARIANTS = {
    "kernel_v4_var_major": (dict(pde_engine="kernel", kernel_interpret=True, kernel_version=4),
                            dict(kernel_version=4)),
    "kernel_v4_point_major": (dict(pde_engine="kernel", kernel_interpret=True, kernel_version=4,
                                   var_major=False),
                              dict(kernel_version=4, var_major=False)),
    "kernel_v4_dict_assembly": (dict(pde_engine="kernel", kernel_interpret=True, kernel_version=4,
                                     packed_assembly=False),
                                dict(kernel_version=4, packed_assembly=False)),
    "kernel_v6": (dict(pde_engine="kernel", kernel_interpret=True, kernel_version=6),
                  dict(kernel_version=6)),
    "kernel_v6_dict_assembly": (dict(pde_engine="kernel", kernel_interpret=True, kernel_version=6,
                                     packed_assembly=False),
                                dict(kernel_version=6, packed_assembly=False)),
    "jvp_v6": (dict(pde_engine="jvp", kernel_version=6), dict(pde_engine="jvp", kernel_version=6)),
    "jvp_v6_dict_assembly": (dict(pde_engine="jvp", kernel_version=6, packed_assembly=False),
                             dict(pde_engine="jvp", kernel_version=6, packed_assembly=False)),
    "linearize": (dict(pde_engine="linearize"), dict(pde_engine="linearize")),
    "l1_pde_criterion": (dict(pde_engine="kernel", kernel_interpret=True, pde_loss="L1Loss"),
                         dict(pde_loss="L1Loss")),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_step_trajectory_of_variant_matches_jax(world, variant):
    """Three PDE steps through one of the step's other routes: every metric of every
    step at METRIC_RTOL, the parameters afterwards within PARAM_ATOL."""
    jfields, tfields = VARIANTS[variant]
    jspecs = j_norm_specs(OBS_CFG)
    jcfg = jts.StepConfig(coord_spec=JaxCoordSpec(**COORD), obs_specs=tuple(jspecs[k] for k in J_ORDER),
                          loss_factor=FACTORS, **jfields)
    jmodel = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    tx = j_build_optimizer(**OPT)
    jstep = jts.make_train_step(jmodel, tx, jcfg)
    jbatch = _jax_batch(world["nb"])
    jstate = jts.create_train_state(jmodel, tx, jax.random.PRNGKey(0), jbatch)
    state = _port_state(_snapshot(jstate))
    step = tts.make_train_step(dataclasses.replace(world["tcfg"], **tfields))
    batch = tts.batch_to_device(world["nb"], device="cpu")
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch, with_pde=True)
        state, tm = step(state, batch, True)
        _assert_metrics_close({k: float(v) for k, v in tm.items()},
                              {k: float(v) for k, v in jm.items()}, f"{variant} step {i}")
        assert float(tm["skipped_nonfinite"]) == 0.0
    _assert_params_close(state.model, jax.tree.map(np.asarray, jstate.params))


def test_kernel_versions_and_layouts_agree(world):
    """kernel_version 4 and 7 and the two layouts of 4 are one function: the same
    losses to float32 rounding from the same state (the v4s pair folds the PE
    derivative into the weights, the v4 pair reads it from dpe)."""
    snaps, jmetrics = world["jax"][True]
    batch = tts.batch_to_device(world["nb"], device="cpu")
    got = {}
    for name, fields in dict(v7=dict(), v4t=dict(kernel_version=4),
                             v4=dict(kernel_version=4, var_major=False), v6=dict(kernel_version=6),
                             v6_jvp=dict(kernel_version=6, pde_engine="jvp"),
                             v4_jvp=dict(kernel_version=4, pde_engine="jvp", var_major=False)).items():
        state = _port_state(snaps[0])
        cfg = dataclasses.replace(world["tcfg"], **fields)
        got[name] = tts.make_eval_step(cfg)(state.model, batch, True)
    for name in ("v4t", "v4", "v4_jvp", "v6", "v6_jvp"):
        for k, v in got["v7"].items():
            np.testing.assert_allclose(float(got[name][k]), float(v), rtol=METRIC_RTOL, err_msg=f"{name} {k}")
    for k, v in got["v4t"].items():  # the two layouts of one pair: the same arithmetic
        np.testing.assert_allclose(float(got["v4"][k]), float(v), rtol=1e-6, err_msg=k)


def test_forecast_h_snap_matches_jax(world):
    fh = np.array([30.0, 47.0, 48.0, 5.5], np.float32)
    jcfg = jts.StepConfig(coord_spec=None, obs_specs=(), loss_factor={}, forecast_h_snap=24.0)
    tcfg = dataclasses.replace(world["tcfg"], forecast_h_snap=24.0)
    np.testing.assert_array_equal(tts._snap_forecast_h(torch.from_numpy(fh), tcfg).numpy(),
                                  np.asarray(jts._snap_forecast_h(jnp.asarray(fh), jcfg)))
    assert tts._snap_forecast_h(torch.from_numpy(fh), world["tcfg"]) is not None
    np.testing.assert_array_equal(tts._snap_forecast_h(torch.from_numpy(fh), world["tcfg"]).numpy(), fh)


def test_step_config_from_cfg_matches_flagship_file():
    import os

    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.window import synthetic_batch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(repo, "configs", "DeepPhysiNet_NCEP_cfg.py"))["config"]
    sc = tts.step_config_from_cfg(cfg)
    assert (sc.coord_spec.lat_size, sc.coord_spec.lon_size) == (145, 257)
    assert sc.loss_factor["vapor_factor"] == 1e14 and sc.prediction_beta == 0.1
    assert (sc.pde_engine, sc.grad_clip_norm) == ("kernel", 2.5e7)
    assert tts.step_config_from_cfg(cfg, pde_engine="jvp").pde_engine == "jvp"
    b = synthetic_batch(cfg, seed=0)
    assert b["field"].shape == (1, 159, 2405) and b["margin"]["labels"].shape == (1, 20480, 6)
    assert b["inter"]["x"].shape == (1, 4096) and b["inter"]["f"].shape == (1, 4096, 1)
    np.testing.assert_array_equal(synthetic_batch(cfg, seed=0)["margin"]["x"], b["margin"]["x"])
