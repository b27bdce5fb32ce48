"""PyTorch port against the JAX package: equations, the residual engines, interpolation.

The same numpy inputs, made from a seed, go through the JAX functions of
``physics/equations.py``, ``physics/engine.py``, ``ops/interp.py`` and
``ops/coords.py`` and their counterparts in the port.  Where the JAX function
reaches a Pallas kernel it runs in interpret mode, as the JAX package's own
tests run it on the CPU; the port's wrappers take their plain versions on CPU
tensors.  Everything is float32.

Tolerances.  Elementwise functions: a few ulp of the result (rtol 1e-5 to 2e-5,
``exp`` in the Tetens formula included).  Functions through the model (one
encoder layer, the hypernet fusion, the decode): rtol 2e-4, as the other port
tests hold matmul chains in another summation order.  Residual losses are
means of squares of differences of large terms (the gas law subtracts two
pressures of 1e5 Pa), each compared relative to itself at 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import coords as jcoords
from deepphysinet_tpu.ops import interp as jinterp
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.physics import engine as jengine
from deepphysinet_tpu.physics import equations as jeqs
from deepphysinet_tpu.train import losses as jlosses
from deepphysinet_tpu.train.point_fn import make_phys_fn as j_make_phys_fn

from deepphysinet_tpu_torch.data.window import Window
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops import coords as tcoords
from deepphysinet_tpu_torch.ops import interp as tinterp
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.physics import engine as tengine
from deepphysinet_tpu_torch.physics import equations as teqs
from deepphysinet_tpu_torch.train import losses as tlosses
from deepphysinet_tpu_torch.train.point_fn import make_phys_fn
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax

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
COORD = dict(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
META = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32,
            activation="gelu", learnable_token_num=8)
NET = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)
KEYS = tengine.FIELD_KEYS
N = 200
MODEL_RTOL = 2e-4
LOSS_RTOL = 1e-3


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _specs():
    js, ts = j_norm_specs(OBS_CFG), norm_specs_from_cfg(OBS_CFG)
    return tuple(js[k] for k in J_ORDER), tuple(ts[k] for k in OBS_NAME_ORDER)


# ---- physics/equations.py, function by function ---------------------------------------------

def _field_dicts(seed=2):
    """Physical fields and derivatives as dicts of [N, 1] numpy columns, and f [N, 1]."""
    rng = np.random.RandomState(seed)
    cols = [3 * rng.randn(N), 3 * rng.randn(N), 90000 + 8000 * rng.randn(N), 283 + 15 * rng.randn(N),
            np.abs(0.008 + 0.006 * rng.randn(N)) + 1e-5, 1.1 + 0.1 * rng.randn(N)]
    cols[4][::3] = 0.05  # saturate part of the points so that the vapor equation's delta switches on
    scales = [1e-4, 1e-4, 1e-2, 1e-4, 1e-7, 1e-5]
    fields = {k: cols[i].astype(np.float32)[:, None] for i, k in enumerate(KEYS)}
    derivs = {k: {ax: (rng.randn(N, 1) * scales[i]).astype(np.float32) for ax in "xyt"}
              for i, k in enumerate(KEYS)}
    return fields, derivs, (1e-4 * rng.rand(N, 1)).astype(np.float32)


def _to(tree, fn):
    return {k: (_to(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["momentum_u_residual", "momentum_v_residual", "continuity_residual",
                                  "energy_residual", "vapor_residual", "gas_residual"])
def test_equation_matches_jax(name):
    fields, derivs, f = _field_dicts()
    args = {"momentum_u_residual": 3, "momentum_v_residual": 3, "gas_residual": 1}.get(name, 2)
    j_args = (_to(fields, jnp.asarray), _to(derivs, jnp.asarray), jnp.asarray(f))
    t_args = (_to(fields, _t), _to(derivs, _t), _t(f))
    if name == "gas_residual":
        want, got = jeqs.gas_residual(j_args[0]), teqs.gas_residual(t_args[0])
    else:
        want, got = getattr(jeqs, name)(*j_args[:args]), getattr(teqs, name)(*t_args[:args])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (N, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-6 * np.abs(w).max())


def test_vapor_residual_detaches_where_jax_stops_gradients():
    """Gradients with respect to p, T and q flow only through the terms outside
    q_s, delta and the F factor."""
    fields, derivs, _ = _field_dicts()

    def j_loss(p, T, q):
        fl = dict(_to(fields, jnp.asarray), p=p, T=T, q=q)
        return jnp.sum(jeqs.vapor_residual(fl, _to(derivs, jnp.asarray))[0] * 1e6)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(fields[k]) for k in ("p", "T", "q")))
    leaves = {k: _t(fields[k]).requires_grad_(True) for k in ("p", "T", "q")}
    diff, _ = teqs.vapor_residual(dict(_to(fields, _t), **leaves), _to(derivs, _t))
    (diff * 1e6).sum().backward()
    assert leaves["T"].grad is None and leaves["q"].grad is None  # reached through detached terms only
    assert not np.asarray(want[1]).any() and not np.asarray(want[2]).any()
    np.testing.assert_allclose(leaves["p"].grad.numpy(), np.asarray(want[0]), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(want[0])).max())
    assert leaves["p"].grad.any()


def test_tetens_and_air_density_match_jax():
    fields, _, _ = _field_dicts()
    p, T, q = fields["p"], fields["T"], fields["q"]
    np.testing.assert_allclose(teqs.saturation_specific_humidity(_t(p), _t(T)).numpy(),
                               np.asarray(jeqs.saturation_specific_humidity(jnp.asarray(p), jnp.asarray(T))),
                               rtol=2e-5)
    leaf = _t(p).requires_grad_(True)
    rho = teqs.air_density(leaf, _t(T), _t(q))
    assert not rho.requires_grad  # held out of the gradient, as in JAX
    np.testing.assert_allclose(rho.numpy(), np.asarray(jeqs.air_density(jnp.asarray(p), jnp.asarray(T),
                                                                        jnp.asarray(q))), rtol=1e-6)


# ---- assembly: normalized primal and tangents -> fields -> losses -------------------------------

def _primal_tangents(seed=0):
    rng = np.random.RandomState(seed)
    primal = rng.randn(N, 6).astype(np.float32)
    # push some q and rho values below their lower clip bound, and some p above
    primal[::5, 4] = -3.0
    primal[1::7, 5] = -9.0
    primal[2::11, 2] = 40.0
    return primal, (rng.randn(3, N, 6) * 1e-4).astype(np.float32)


@pytest.mark.parametrize("with_clip", [True, False])
def test_fields_from_primal_tangents_matches_jax(with_clip):
    jspecs, tspecs = _specs()
    primal, tang = _primal_tangents()
    want = jengine.fields_from_primal_tangents(jnp.asarray(primal), jnp.asarray(tang), jspecs, with_clip)
    got = tengine.fields_from_primal_tangents(_t(primal), _t(tang), tspecs, with_clip)
    for k in KEYS:
        np.testing.assert_allclose(got.fields[k].numpy(), np.asarray(want.fields[k]), rtol=1e-6)
        for ax in "xyt":
            np.testing.assert_allclose(got.derivs[k][ax].numpy(), np.asarray(want.derivs[k][ax]), rtol=1e-6)
    if with_clip:  # where the clip is active the derivative is zero
        assert not got.derivs["q"]["x"].numpy()[::5].any() and got.derivs["u"]["x"].numpy().all()
    # the packed [N, 6] assembly is the vectorized form of the same chain rule
    pf, pd = tengine.packed_physical_from_primal_tangents(_t(primal), _t(tang), tspecs, with_clip)
    jf, jd = jengine.packed_physical_from_primal_tangents(jnp.asarray(primal), jnp.asarray(tang), jspecs,
                                                          with_clip)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6)
    for i, k in enumerate(KEYS):
        np.testing.assert_array_equal(pf[i].numpy(), got.fields[k][:, 0].numpy())
        np.testing.assert_array_equal(pd[1, i].numpy(), got.derivs[k]["y"][:, 0].numpy())


@pytest.mark.parametrize("criterion", [None, "L1Loss", "SmoothL1Loss"])
def test_residual_losses_from_fields_matches_jax(criterion):
    fields, derivs, f = _field_dicts()
    j_crit = None if criterion is None else jlosses.build_loss(criterion)
    t_crit = None if criterion is None else tlosses.build_loss(criterion)
    want = jengine.residual_losses_from_fields(
        jengine.FieldDerivatives(_to(fields, jnp.asarray), _to(derivs, jnp.asarray)), jnp.asarray(f),
        FACTORS, criterion=j_crit)
    got = tengine.residual_losses_from_fields(
        tengine.FieldDerivatives(_to(fields, _t), _to(derivs, _t)), _t(f), FACTORS, criterion=t_crit)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=2e-5, err_msg=k)


def test_packed_losses_from_point_major_layout_match_jax():
    jspecs, tspecs = _specs()
    primal, tang = _primal_tangents()
    primal[:, 5] = np.abs(primal[:, 5]) * 0.1  # keep rho away from zero: the equations divide by it
    f = (1e-4 * np.random.RandomState(3).rand(N, 1)).astype(np.float32)
    want = jengine.packed_residual_losses_from_primal_tangents(
        jnp.asarray(primal), jnp.asarray(tang), jnp.asarray(f), jspecs, FACTORS)
    got = tengine.packed_residual_losses_from_primal_tangents(_t(primal), _t(tang), _t(f), tspecs, FACTORS)
    dict_form = tengine.residual_losses_from_fields(
        tengine.fields_from_primal_tangents(_t(primal), _t(tang), tspecs, True), _t(f), FACTORS)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(dict_form[k]), float(w), rtol=2e-5, err_msg=k)


# ---- through the model -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """A tiny model with the same weights in both packages, and the points of one window."""
    rng = np.random.RandomState(9)
    jmodel = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    field = rng.randn(1, 12, META["enc_in"]).astype(np.float32)
    fh = np.array([[0.2]], np.float32)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(field), jnp.zeros((2, 192)),
                         jnp.zeros((2, 6)), jnp.asarray(fh))
    jtokens = jmodel.apply(params, jnp.asarray(field), jnp.asarray(fh), method=JaxPhysicsNet.encode)[0]
    tmodel = PhysicsNet(META, NET, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        ttokens = tmodel.encode(_t(field), _t(fh))[0]
    n = 96
    coords = np.stack([rng.rand(n) * 27000 * 256, rng.rand(n) * 27000 * 144,
                       rng.randint(0, 25, n) * 3600.0], -1).astype(np.float32)
    nwp = (rng.randn(n, 6) * 0.1).astype(np.float32)
    f = (1e-4 * rng.rand(n, 1)).astype(np.float32)
    jspecs, tspecs = _specs()
    return dict(jmodel=jmodel, params=params, jtokens=jtokens, tmodel=tmodel, ttokens=ttokens,
                coords=coords, nwp=nwp, f=f, fh=fh[0], jspecs=jspecs, tspecs=tspecs,
                jspec=jcoords.CoordSpec(**COORD), tspec=tcoords.CoordSpec(**COORD))


def _j_args(w):
    return (w["jmodel"], w["params"], w["jtokens"], jnp.asarray(w["coords"]), jnp.asarray(w["nwp"]),
            jnp.asarray(w["fh"]))


def _t_args(w):
    return (w["tmodel"], w["ttokens"], _t(w["coords"]), _t(w["nwp"]), _t(w["fh"]))


def _assert_fields_close(got, want):
    for k in KEYS:
        w = np.asarray(want.fields[k])
        np.testing.assert_allclose(got.fields[k].detach().numpy(), w, rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL * np.abs(w).max(), err_msg=k)
        for ax in "xyt":
            w = np.asarray(want.derivs[k][ax])
            np.testing.assert_allclose(got.derivs[k][ax].detach().numpy(), w, rtol=MODEL_RTOL,
                                       atol=MODEL_RTOL * np.abs(w).max(), err_msg=f"{k} {ax}")


@pytest.mark.parametrize("version", [4, 6, 7])
def test_jvp_fields_matches_jax(world, version):
    p_j, fd_j = jengine.jvp_fields(*_j_args(world), world["jspec"], world["jspecs"], version=version)
    p_t, fd_t = tengine.jvp_fields(*_t_args(world), world["tspec"], world["tspecs"], version=version)
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=MODEL_RTOL, atol=2e-5)
    _assert_fields_close(fd_t, fd_j)
    assert p_t.requires_grad  # differentiable by autograd, as the 'jvp' engine needs


@pytest.mark.parametrize("trainable", [False, True])
def test_fused_kernel_fields_v4_matches_jax(world, trainable):
    p_j, fd_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"],
                                            interpret=True, trainable=trainable, version=4)
    p_t, fd_t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                            trainable=trainable, version=4)
    assert tuple(p_t.shape) == (96, 6)
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=MODEL_RTOL, atol=2e-5)
    _assert_fields_close(fd_t, fd_j)
    # the raw tangents instead of the assembled fields, as the packed assembly takes them
    _, tang = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                          version=7, raw_tangents=True)  # 7 means the v4 algebra here
    _, tang_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"],
                                            interpret=True, version=4, raw_tangents=True)
    assert tuple(tang.shape) == (3, 96, 6)
    np.testing.assert_allclose(tang.detach().numpy(), np.asarray(tang_j), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * float(jnp.max(jnp.abs(tang_j))))


@pytest.mark.parametrize("raw_tangents", [False, True])
@pytest.mark.parametrize("trainable", [False, True])
def test_fused_kernel_fields_v6_matches_jax(world, trainable, raw_tangents):
    """``version=6``: the v6 Pallas pair in interpret mode against the port's plain versions."""
    p_j, out_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"], interpret=True,
                                             trainable=trainable, version=6, raw_tangents=raw_tangents)
    p_t, out_t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                             trainable=trainable, version=6, raw_tangents=raw_tangents)
    assert tuple(p_t.shape) == (96, 6) and (p_t.requires_grad or not trainable)
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=MODEL_RTOL, atol=2e-5)
    if raw_tangents:
        assert tuple(out_t.shape) == (3, 96, 6)
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL * float(jnp.max(jnp.abs(out_j))))
    else:
        _assert_fields_close(out_t, out_j)


def test_version_6_is_the_version_4_function(world):
    """float32: the v6 fold moves the PE derivative into the weights and changes no value
    beyond rounding, under both engines; and the two forms of the cd PE that the JAX
    engine uses (``sinecos_pe`` for 6, ``sinecos_pe_flat`` for 4 and 7) are one array."""
    for fn in (tengine.fused_kernel_fields, tengine.jvp_fields):
        p4, t4 = fn(*_t_args(world), world["tspec"], world["tspecs"], version=4, raw_tangents=True)
        p6, t6 = fn(*_t_args(world), world["tspec"], world["tspecs"], version=6, raw_tangents=True)
        np.testing.assert_allclose(p6.detach().numpy(), p4.detach().numpy(), rtol=MODEL_RTOL, atol=2e-5)
        np.testing.assert_allclose(t6.detach().numpy(), t4.detach().numpy(), rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL * float(t4.detach().abs().max()))
    nwp = _t(world["nwp"])
    _, _, cd_pe6 = tengine._kernel_inputs_6(*_t_args(world), world["tspec"])
    assert cd_pe6.dtype == torch.float32
    np.testing.assert_array_equal(cd_pe6.numpy(), tengine._cd_pe(world["tmodel"], nwp).numpy())


@pytest.mark.parametrize("version", [4, 7])
def test_fused_kernel_fields_t_matches_jax(world, version):
    p_j, t_j = jengine.fused_kernel_fields_t(*_j_args(world), world["jspec"], interpret=True, version=version)
    for engine in ("kernel", "jvp"):
        p_t, t_t = tengine.fused_kernel_fields_t(*_t_args(world), world["tspec"], engine=engine,
                                                 version=version)
        assert tuple(p_t.shape) == (6, 96) and tuple(t_t.shape) == (3, 6, 96)
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=MODEL_RTOL, atol=2e-5)
        np.testing.assert_allclose(t_t.detach().numpy(), np.asarray(t_j), rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL * float(jnp.max(jnp.abs(t_j))))


@pytest.mark.parametrize("version", [4, 7])
def test_fused_residual_losses_matches_jax(world, version):
    want = jengine.fused_residual_losses(*_j_args(world), jnp.asarray(world["f"]), world["jspec"],
                                         world["jspecs"], FACTORS, interpret=True, version=version)
    got = tengine.fused_residual_losses(*_t_args(world), _t(world["f"]), world["tspec"], world["tspecs"],
                                        FACTORS, version=version)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(w), rtol=LOSS_RTOL, err_msg=k)


def test_linearize_engine_matches_jax(world):
    """``linearized_fields`` and ``pde_residual_losses`` over ``make_phys_fn``:
    ``torch.func.jvp`` against ``jax.linearize``, and gradients to the parameters."""
    j_fn = j_make_phys_fn(world["jmodel"], world["params"], world["jtokens"], jnp.asarray(world["nwp"]),
                          jnp.asarray(world["fh"]), world["jspec"], world["jspecs"])
    t_fn = make_phys_fn(world["tmodel"], world["ttokens"], _t(world["nwp"]), _t(world["fh"]),
                        world["tspec"], world["tspecs"])
    fd_j = jengine.linearized_fields(j_fn, jnp.asarray(world["coords"]))
    fd_t = tengine.linearized_fields(t_fn, _t(world["coords"]))
    _assert_fields_close(fd_t, fd_j)
    # the analytic tangents of the collapsed decode are the same derivatives
    _, fd_a = tengine.jvp_fields(*_t_args(world), world["tspec"], world["tspecs"])
    for k in KEYS:
        scale = float(fd_t.derivs[k]["x"].detach().abs().max())
        np.testing.assert_allclose(fd_a.derivs[k]["x"].detach().numpy(), fd_t.derivs[k]["x"].detach().numpy(),
                                   rtol=1e-3, atol=1e-3 * scale)
    want = jengine.pde_residual_losses(j_fn, jnp.asarray(world["coords"]), jnp.asarray(world["f"]), FACTORS)
    got = tengine.pde_residual_losses(t_fn, _t(world["coords"]), _t(world["f"]), FACTORS)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=LOSS_RTOL, err_msg=k)
    got["total"].backward()  # reverse mode over forward mode reaches the hypernet
    grads = [p.grad for p in world["tmodel"].U_net.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads) and any(g.any() for g in grads)
    world["tmodel"].zero_grad(set_to_none=True)


def test_unported_versions_name_their_roadmap_item(world):
    """The versions that waited for ROADMAP B8 run now, by JAX's routes (the item is done):
    ``fused_kernel_fields`` takes the v2 decode for 2 and, as JAX does, for 3 and 5 (C20),
    not their own kernels; ``jvp_fields`` takes the v4 twin for every version but 6;
    ``fused_kernel_fields_t`` refuses what JAX's var-major step never takes."""
    p_j, t_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"], interpret=True,
                                           version=2, raw_tangents=True)
    p2, t2 = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"], version=2,
                                         raw_tangents=True)
    np.testing.assert_allclose(p2.detach().numpy(), np.asarray(p_j), rtol=MODEL_RTOL, atol=2e-5)
    np.testing.assert_allclose(t2.detach().numpy(), np.asarray(t_j), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * float(jnp.max(jnp.abs(t_j))))
    p4, _ = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"], version=4,
                                        raw_tangents=True)
    assert not torch.equal(p2, p4)  # the uncollapsed decode rounds otherwise than v4
    for version in (3, 5):
        p, t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"], version=version,
                                           raw_tangents=True)
        assert torch.equal(p, p2) and torch.equal(t, t2), version
    j_twin = jengine.jvp_fields(*_j_args(world), world["jspec"], world["jspecs"], version=4, raw_tangents=True)
    for version in (2, 3, 5):
        p, t = tengine.jvp_fields(*_t_args(world), world["tspec"], world["tspecs"], version=version,
                                  raw_tangents=True)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_twin[0]), rtol=MODEL_RTOL, atol=2e-5)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j_twin[1]), rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL * float(jnp.max(jnp.abs(j_twin[1]))))
    for version in (2, 6):
        with pytest.raises(ValueError, match=f"version {version} has no var-major form"):
            tengine.fused_kernel_fields_t(*_t_args(world), world["tspec"], version=version)
    with pytest.raises(ValueError, match="unknown engine"):
        tengine.fused_kernel_fields_t(*_t_args(world), world["tspec"], engine="linearize")


# ---- ops/interp.py and ops/coords.py ----------------------------------------------------------

def _cube_and_points(seed=4, n=500):
    rng = np.random.RandomState(seed)
    cube = rng.randn(6, 10, 17, 5).astype(np.float32)
    # inside the grid, on its nodes, and outside it (clipped)
    lon = np.concatenate([72 + 16 * rng.rand(n), [72.0, 88.0, 80.0, 60.0, 99.0]])
    lat = np.concatenate([18 + 9 * rng.rand(n), [18.0, 27.0, 20.0, 10.0, 40.0]])
    t = np.concatenate([24 * rng.rand(n), [0.0, 24.0, 6.0, -3.0, 30.0]])
    return cube, lon.astype(np.float32), lat.astype(np.float32), t.astype(np.float32)


def test_trilinear_interp_cube_matches_jax_and_window():
    cube, lon, lat, t = _cube_and_points()
    grid = dict(lon0=72.0, dlon=1.0, lat0=18.0, dlat=1.0, t0=0.0, dt=6.0)
    want = jinterp.trilinear_interp_cube(jnp.asarray(cube), jnp.asarray(lon), jnp.asarray(lat),
                                         jnp.asarray(t), **grid)
    got = tinterp.trilinear_interp_cube(_t(cube), _t(lon), _t(lat), _t(t), **grid)
    assert tuple(got.shape) == (6, len(lon)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the host interpolation of the inference path (numpy, float64) is the same function
    window = Window(field=np.zeros((1, 1), np.float32), nwp_cube=cube, forecast_h=0.0,
                    in_lon=72.0 + np.arange(17.0), in_lat=18.0 + np.arange(10.0),
                    out_lon=np.array([72.0, 72.25]), out_lat=np.array([18.0, 18.25]), dx=1.0, dy=1.0)
    np.testing.assert_allclose(got.numpy().T, window.interp_cube_at(lon, lat, t), rtol=1e-5, atol=2e-5)
    # a single time level or row: the degenerate axes of _gather_trilinear
    one = tinterp.trilinear_interp_cube(_t(cube[..., :1]), _t(lon), _t(lat), _t(t), **grid)
    one_j = jinterp.trilinear_interp_cube(jnp.asarray(cube[..., :1]), jnp.asarray(lon), jnp.asarray(lat),
                                          jnp.asarray(t), **grid)
    np.testing.assert_allclose(one.numpy(), np.asarray(one_j), rtol=1e-6, atol=1e-6)


def test_coriolis_matches_jax():
    lat = np.linspace(-80, 80, 33).astype(np.float32)
    got = tcoords.coriolis(_t(lat))
    assert tuple(got.shape) == (33, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcoords.coriolis(jnp.asarray(lat))), rtol=1e-6,
                               atol=1e-12)
    assert tuple(tcoords.coriolis(_t(lat)[:, None]).shape) == (33, 1)
