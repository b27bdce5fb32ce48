"""PyTorch port against the JAX package: packed residual assembly, losses, optimizer.

The same numpy inputs, made from a seed, go through the JAX functions of
``physics/engine.py``, ``train/losses.py`` and ``train/optim.py`` and their
counterparts in the port.  Everything here is float32 elementwise math, so the
tolerances are a few ulp of the largest term; the gradients of the six
residual losses pin where the port detaches (``q_s``, ``delta``, ``f_fac``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.physics import engine as jengine
from deepphysinet_tpu.train import losses as jlosses
from deepphysinet_tpu.train import optim as joptim

from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.physics import engine as tengine
from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants
from deepphysinet_tpu_torch.train import losses as tlosses
from deepphysinet_tpu_torch.train import optim as toptim

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

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
N = 257


def _specs():
    js, ts = j_norm_specs(OBS_CFG), norm_specs_from_cfg(OBS_CFG)
    return tuple(js[k] for k in J_ORDER), tuple(ts[k] for k in OBS_NAME_ORDER)


def _primal_tangents(seed=0):
    rng = np.random.RandomState(seed)
    primal = rng.randn(6, N).astype(np.float32)
    # push some q and rho values below their lower clip bound, and some p above
    primal[4, ::5] = -3.0
    primal[5, 1::7] = -9.0
    primal[2, 2::11] = 40.0
    tang = (rng.randn(3, 6, N) * 1e-4).astype(np.float32)
    return primal, tang


def test_constants_match_jax():
    from deepphysinet_tpu.physics.constants import DEFAULT_CONSTANTS as J
    import dataclasses

    assert dataclasses.asdict(DEFAULT_CONSTANTS) == dataclasses.asdict(J)
    assert PhysicalConstants(r_d=1.0).r_d == 1.0


@pytest.mark.parametrize("with_clip", [True, False])
def test_packed_physical_matches_jax(with_clip):
    jspecs, tspecs = _specs()
    primal, tang = _primal_tangents()
    want_f, want_d = jengine.packed_physical_from_primal_tangents_t(
        jnp.asarray(primal), jnp.asarray(tang), jspecs, with_clip)
    got_f, got_d = tengine.packed_physical_from_primal_tangents_t(
        torch.from_numpy(primal), torch.from_numpy(tang), tspecs, with_clip)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    if with_clip:  # the clip is active somewhere, and there the derivative is zero
        assert (got_f.numpy()[4, ::5] == np.float32(1e-6)).all()
        assert not got_d.numpy()[:, 4, ::5].any() and got_d.numpy()[:, 0].all()


def test_tetens_matches_jax():
    rng = np.random.RandomState(1)
    p = (90000 + 8000 * rng.randn(N)).astype(np.float32)
    T = (283 + 15 * rng.randn(N)).astype(np.float32)
    want = jengine.saturation_specific_humidity_packed(jnp.asarray(p), jnp.asarray(T))
    got = tengine.saturation_specific_humidity_packed(torch.from_numpy(p), torch.from_numpy(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)


def _physical_inputs(seed=2):
    rng = np.random.RandomState(seed)
    fields = np.stack([
        3 * rng.randn(N), 3 * rng.randn(N), 90000 + 8000 * rng.randn(N), 283 + 15 * rng.randn(N),
        np.abs(0.008 + 0.006 * rng.randn(N)) + 1e-5, 1.1 + 0.1 * rng.randn(N)]).astype(np.float32)
    # saturate part of the points so that the vapor equation's delta switches on
    fields[4, ::3] = 0.05
    derivs = (rng.randn(3, 6, N) * np.array([1e-4, 1e-4, 1e-2, 1e-4, 1e-7, 1e-5])[None, :, None]
              ).astype(np.float32)
    f = (1e-4 * rng.rand(N, 1)).astype(np.float32)
    return fields, derivs, f


def test_residual_losses_and_gradients_match_jax():
    fields, derivs, f = _physical_inputs()
    want = jengine.residual_losses_packed(jnp.asarray(fields), jnp.asarray(derivs), jnp.asarray(f),
                                          FACTORS)
    tf = torch.from_numpy(fields).requires_grad_(True)
    td = torch.from_numpy(derivs).requires_grad_(True)
    got = tengine.residual_losses_packed(tf, td, torch.from_numpy(f), FACTORS)
    assert sorted(got) == sorted(want)
    assert float(got["vapor_loss"].detach()) > 0  # delta is on somewhere
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=2e-5, err_msg=k)

    # gradients of each loss by itself, so that none hides behind a larger one;
    # the vapor loss pins the detach placement (q_s, delta, f_fac)
    for k in ("montion_u_loss", "montion_v_loss", "continous_loss", "energy_loss", "vapor_loss",
              "gas_loss", "total"):
        jf, jd = jax.grad(lambda a, b: jengine.residual_losses_packed(a, b, jnp.asarray(f), FACTORS)[k],
                          argnums=(0, 1))(jnp.asarray(fields), jnp.asarray(derivs))
        gf, gd = torch.autograd.grad(got[k], (tf, td), retain_graph=True, allow_unused=True)
        gd = torch.zeros_like(td) if gd is None else gd  # the gas law has no derivative term
        for a, b, name in ((gf, jf, "fields"), (gd, jd, "derivs")):
            b = np.asarray(b)
            for row in range(6):  # per variable: their magnitudes differ by 1e10
                bb = b[row] if name == "fields" else b[:, row]
                aa = a.numpy()[row] if name == "fields" else a.numpy()[:, row]
                np.testing.assert_allclose(aa, bb, rtol=1e-4, atol=1e-5 * np.abs(bb).max(),
                                           err_msg=f"{k} d/d{name}[{row}]")


def test_packed_residual_losses_from_primal_tangents_matches_jax():
    jspecs, tspecs = _specs()
    rng = np.random.RandomState(3)
    primal = (0.3 * rng.randn(6, N)).astype(np.float32)
    tang = (rng.randn(3, 6, N) * 1e-5).astype(np.float32)
    f = (1e-4 * rng.rand(N, 1)).astype(np.float32)
    want = jengine.packed_residual_losses_from_primal_tangents_t(
        jnp.asarray(primal), jnp.asarray(tang), jnp.asarray(f), jspecs, FACTORS)
    got = tengine.packed_residual_losses_from_primal_tangents_t(
        torch.from_numpy(primal), torch.from_numpy(tang), torch.from_numpy(f), tspecs, FACTORS)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("name, kwargs", [
    ("MSELoss", {}), ("L1Loss", {}), ("WeightSmoothL1Loss", dict(beta=0.1)),
    ("SmoothL1Loss", {}), ("SmoothL1Loss", dict(beta=0.5))])
def test_losses_match_jax(name, kwargs):
    rng = np.random.RandomState(4)
    pred, target = rng.randn(6, 301).astype(np.float32), rng.randn(6, 301).astype(np.float32)
    want = jlosses.build_loss(name, **kwargs)(jnp.asarray(pred), jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = tlosses.build_loss(name, **kwargs)(tp, torch.from_numpy(target))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-6)
    jg = jax.grad(lambda p: jlosses.build_loss(name, **kwargs)(p, jnp.asarray(target)))(jnp.asarray(pred))
    (tg,) = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(KeyError, match="KLDivLoss"):  # in neither package's registry
        tlosses.build_loss("KLDivLoss")
    with pytest.raises(KeyError, match="Lion"):
        toptim.build_optimizer("Lion", params=[torch.nn.Parameter(torch.zeros(1))])


@pytest.mark.parametrize("weight_decay", [1e-4, 0.0])
def test_adam_three_steps_match_jax(weight_decay):
    """torch.optim.Adam(weight_decay) is the coupled L2 that the optax build reproduces."""
    import optax

    rng = np.random.RandomState(5)
    shapes = dict(a=(7, 5), b=(5,), c=(3, 4, 2))
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 3)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = joptim.build_optimizer("Adam", lr=1e-3, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.build_optimizer("Adam", params=tp.values(), lr=1e-3, weight_decay=weight_decay)
    for i, g in enumerate(grads):
        if i == 2:  # a learning-rate change at an epoch boundary, in both
            opt_state = joptim.set_learning_rate(opt_state, 5e-4)
            toptim.set_learning_rate(opt, 5e-4)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=2e-6, atol=2e-7,
                                   err_msg=k)
