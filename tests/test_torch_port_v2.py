"""PyTorch port against the JAX package: the uncollapsed decode of ``kernel_version=2``
(v2) and its in-kernel-PE form (v3).

The same numpy inputs, made from a seed, go through the JAX functions of
``deepphysinet_tpu/ops/decode_kernel.py`` and their counterparts in
``deepphysinet_tpu_torch/ops/decode_kernel.py``.  The Pallas kernels run as the JAX
package's own tests run them on the CPU (``tests/test_decode_kernel.py``), in interpret
mode.  On the CPU the port's wrappers take their plain versions, which is what these tests
hold to JAX; the CUDA kernels are held to the same plain versions on the card (the tests
marked ``cuda`` here, and ``chip_smoke.py``).

Bars, the JAX tests' own (``tests/test_decode_kernel.py:93-97``): primal rtol 2e-4 and
atol 2e-5; tangents rtol 2e-3, with an absolute floor of 2e-3 of the largest tangent (the
tangents carry the scales 1 / (dx (lon - 1)), so a floor in absolute units would hide
them).  Both sides round at the same places, so what is left is float32 summation order
and, in bfloat16, a flipped rounding of an operand.

What the plain versions are held to:

* ``decode_jvp_v2_ref`` against the v2 Pallas kernel (``wo`` rounded to the compute
  dtype, as the kernel's wrapper casts it) and, with ``round_wo=False``, against the XLA
  twin ``decode_jvp_xla``, which reads ``wo`` in float32 (ROADMAP C19: the two agree in
  float32 and differ in bfloat16);
* ``FusedDecodeJvpV2`` (kernel forward, plain backward) against ``jax.vjp`` of the twin,
  the backward of JAX's ``fused_decode_jvp_trainable``;
* ``decode_jvp_v3_ref`` against the v3 Pallas kernel, and ``pe_front_end`` against the
  channel-major PE that the v3 kernel builds;
* the engine's version-2 routes (``fused_kernel_fields``, ``fused_residual_losses`` on
  both sides of ``FUSED_ASSEMBLY_MIN_N``) against JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.ops import decode_kernel as jdk
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.position_encoding import make_freq_bands as j_bands
from deepphysinet_tpu.ops.position_encoding import sinecos_pe as j_sinecos_pe
from deepphysinet_tpu.physics import engine as jengine

from deepphysinet_tpu_torch.ops import decode_kernel as tdk
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.physics import engine as tengine

from tests.test_torch_port_engine import FACTORS, _j_args, _t_args, world  # noqa: F401

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

F, HID, NV = 8, 32, 6
IN_CH, TWO_F = 6 * F, 2 * F
BLOCK = 32
SPEC = dict(lon_size=17, lat_size=9, dx=27000.0, dy=27000.0, pred_t_span=86400.0, n_freqs=F)
FIELDS = tdk.DecodeWeights._fields
TOL = dict(primal=(2e-4, 2e-5), tangent=2e-3)


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(n, seed=3):
    """Decode weights, coordinates, conditioning values and reference values as numpy."""
    rng = np.random.RandomState(seed)

    def r(*s, scale=0.3):
        return (rng.randn(*s) * scale).astype(np.float32)

    w = dict(w1=r(NV, IN_CH, HID), b1=r(NV, HID), w2=r(NV, HID, HID), b2=r(NV, HID),
             wd=r(NV, IN_CH, HID), bd=r(NV, HID), fh_add=r(NV, HID), f1=r(NV, HID, HID),
             g1=r(NV, HID), f2=r(NV, HID, HID), g2=r(NV, HID), wo=r(NV, HID), bo=r(NV))
    coords = np.stack([rng.rand(n) * 27000 * (SPEC["lon_size"] - 1),
                       rng.rand(n) * 27000 * (SPEC["lat_size"] - 1),
                       rng.randint(0, 25, n) * 3600.0], -1).astype(np.float32)
    return dict(w=w, coords=coords, cdata=r(n, NV, scale=1.0), ref=r(n, NV),
                g_p=r(n, NV, scale=1.0), g_t=r(3, n, NV, scale=1e4))


def _jax_side(inp):
    """``DecodeWeights`` and the float32 point inputs of the JAX package."""
    spec = JaxCoordSpec(**SPEC)
    pe, dpe = jdk.pe_and_tangents(jnp.asarray(inp["coords"]), spec)
    cd_pe = j_sinecos_pe(jnp.asarray(inp["cdata"]), j_bands(IN_CH // 12, 4.0), include_input=False)
    return (jdk.DecodeWeights(**{k: jnp.asarray(v) for k, v in inp["w"].items()}), pe, dpe, cd_pe,
            jnp.asarray(inp["ref"]))


def _port_side(inp, dtype="float32"):
    """The port's counterparts, the point operands in ``dtype`` as the engine hands them on."""
    spec, td = CoordSpec(**SPEC), getattr(torch, dtype)
    pe, dpe = tdk.pe_and_tangents(_t(inp["coords"]), spec, td)
    cd_pe = sinecos_pe(_t(inp["cdata"]), make_freq_bands(IN_CH // 12, 4.0)).to(td)
    return tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()}), pe, dpe, cd_pe, _t(inp["ref"])


def _assert_outputs_close(p, t, p_want, t_want):
    p_want, t_want = np.asarray(p_want, np.float32), np.asarray(t_want, np.float32)
    rtol, atol = TOL["primal"]
    np.testing.assert_allclose(_np(p), p_want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(t), t_want, rtol=TOL["tangent"], atol=TOL["tangent"] * np.abs(t_want).max())


# ---- v2: the plain forward ------------------------------------------------------------------

# the points of the Pallas run that every case of the plain forward reads its first points from:
# one past two 64-point blocks of the port's tensor-core kernel
V2_POINTS = 129


def _first_points(inp, n):
    """The first n points of ``_inputs``' per-point arrays (the weights unchanged)."""
    return dict(inp, coords=inp["coords"][:n], cdata=inp["cdata"][:n], ref=inp["ref"][:n],
                g_p=inp["g_p"][:n], g_t=inp["g_t"][:, :n])


@functools.lru_cache(maxsize=None)
def _pallas_forward(dtype):
    """The v2 Pallas kernel (interpret mode) on the V2_POINTS points of ``_inputs(V2_POINTS)``,
    once per dtype: each point's outputs depend on its own inputs only, so a case at n points
    reads the first n of them."""
    p_k, t_k = jdk.fused_decode_jvp(*_jax_side(_inputs(V2_POINTS)), block_n=BLOCK, interpret=True,
                                    compute_dtype=getattr(jnp, dtype))
    return np.asarray(p_k), np.asarray(t_k)


# n = 50 is ragged against the Pallas block of 32; 1, 17, 64, 65 and 129 are the point-block
# edges of the port's tensor-core kernel (64 points a block), where chip_smoke.py holds it to this
# plain version
@pytest.mark.parametrize("n", [64, 50, 1, 17, 65, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_kernel(dtype, n):
    p_k, t_k = _pallas_forward(dtype)
    p_k, t_k = p_k[:n], t_k[:, :n]
    w, pe, dpe, cd_pe, ref = _port_side(_first_points(_inputs(V2_POINTS), n), dtype)
    before = tdk.fused_decode_jvp.launches
    p, t = tdk.fused_decode_jvp(w, pe, dpe, cd_pe, ref, getattr(torch, dtype))
    assert tdk.fused_decode_jvp.launches == before  # no kernel was launched
    assert tuple(p.shape) == (n, NV) and tuple(t.shape) == (3, n, NV) and p.dtype == torch.float32
    _assert_outputs_close(p, t, p_k, t_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_with_twin_rounding_matches_xla_twin(dtype):
    inp = _inputs(64)
    p_x, t_x = jdk.decode_jvp_xla(*_jax_side(inp), getattr(jnp, dtype))
    w, pe, dpe, cd_pe, ref = _port_side(inp, dtype)
    p, t = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, getattr(torch, dtype), round_wo=False)
    _assert_outputs_close(p, t, p_x, t_x)


def test_kernel_rounds_wo_where_the_twin_does_not():
    """ROADMAP C19.  The v2 kernel's wrapper casts the head ``wo`` to the compute dtype
    (:264), its XLA twin reads it in float32 (:1824): the same function in float32, two in
    bfloat16.  ``round_wo`` picks one; the JAX kernel and twin differ the same way."""
    inp = _inputs(64)
    w, pe, dpe, cd_pe, ref = _port_side(inp)
    kern = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, torch.float32, round_wo=True)
    twin = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, torch.float32, round_wo=False)
    for a, b in zip(kern, twin):
        np.testing.assert_array_equal(_np(a), _np(b))
    bf = torch.bfloat16
    w, pe, dpe, cd_pe, ref = _port_side(inp, "bfloat16")
    kern = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, bf, round_wo=True)
    twin = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, bf, round_wo=False)
    jw, jpe, jdpe, jcd, jref = _jax_side(inp)
    j_kern = jdk.fused_decode_jvp(jw, jpe, jdpe, jcd, jref, block_n=BLOCK, interpret=True,
                                  compute_dtype=jnp.bfloat16)
    j_twin = jdk.decode_jvp_xla(jw, jpe, jdpe, jcd, jref, jnp.bfloat16)
    for a, b, ja, jb in zip(kern, twin, j_kern, j_twin):
        gap, j_gap = _np(a) - _np(b), np.asarray(ja) - np.asarray(jb)
        assert np.abs(gap).max() > 1e-4 * np.abs(_np(b)).max()  # far above float32 rounding
        np.testing.assert_allclose(gap, j_gap, rtol=0, atol=0.2 * np.abs(j_gap).max())


def test_v2_is_the_v4_function():
    """float32: the collapsed v4 algebra re-associates the same products."""
    inp = _inputs(64)
    w, pe, dpe, cd_pe, ref = _port_side(inp)
    p2, t2 = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, torch.float32)
    p4, t4 = tdk.decode_jvp_v4_ref(tdk.fuse_decode_weights(w), pe, dpe, cd_pe, ref, torch.float32)
    _assert_outputs_close(p2, t2, _np(p4), _np(t4))


# ---- v2: the autograd.Function --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_gradients_match_jax_vjp_of_twin(dtype):
    """``FusedDecodeJvpV2``: the kernel's forward (its plain version here) and the twin's
    vector-Jacobian product for every input, as JAX's ``fused_decode_jvp_trainable``
    (:1827-1862).  The cotangents of the weights, ``pe``, ``dpe``, ``cd_pe`` and ``ref``
    within 1e-4 of each one's largest (float32 sums in another order); in bfloat16 both
    sides round at the same places, and a flipped rounding moves a sum by 2^-9 of one term."""
    inp = _inputs(64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jw, jpe, jdpe, jcd, jref = _jax_side(inp)
    j_pts = [x.astype(jd) for x in (jpe, jdpe, jcd)]
    g = (jnp.asarray(inp["g_p"]), jnp.asarray(inp["g_t"]))
    _, vjp = jax.vjp(lambda *a: jdk.decode_jvp_xla(*a, jd), jw, *j_pts, jref)
    want = vjp(g)

    w, pe, dpe, cd_pe, ref = _port_side(inp, dtype)
    leaves = tdk.DecodeWeights(*(x.clone().requires_grad_(True) for x in w))
    pts = [x.clone().requires_grad_(True) for x in (pe, dpe, cd_pe, ref)]
    p, t = tdk.fused_decode_jvp_trainable(leaves, *pts, td)
    ((p * _t(inp["g_p"])).sum() + (t * _t(inp["g_t"])).sum()).backward()
    kern = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, ref, td)  # the forward is the kernel's
    np.testing.assert_array_equal(_np(p), _np(kern[0]))
    np.testing.assert_array_equal(_np(t), _np(kern[1]))
    tol = 1e-4 if dtype == "float32" else 1e-2
    got = [x.grad for x in leaves] + [x.grad for x in pts]
    names = list(FIELDS) + ["pe", "dpe", "cd_pe", "ref"]
    for name, a, b in zip(names, got, list(want[0]) + list(want[1:])):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-30), err_msg=name)


def test_autograd_function_takes_only_the_gradients_it_is_asked_for():
    inp = _inputs(16)
    w, pe, dpe, cd_pe, ref = _port_side(inp)
    leaves = tdk.DecodeWeights(*(x.clone().requires_grad_(k in ("w1", "wo")) for k, x in zip(FIELDS, w)))
    p, t = tdk.fused_decode_jvp_trainable(leaves, pe, dpe, cd_pe, ref, torch.float32)
    assert len(p.grad_fn.saved_tensors) == 4 + len(FIELDS)  # the inputs only, no activations
    (p.sum() + t.sum()).backward()
    assert leaves.w1.grad.abs().max() > 0 and leaves.wo.grad.abs().max() > 0
    assert all(x.grad is None for k, x in zip(FIELDS, leaves) if k not in ("w1", "wo"))
    assert pe.grad is None and ref.grad is None


# ---- v3 and the in-kernel PE front end --------------------------------------------------------

def test_pe_front_end_is_the_v3_kernels_pe():
    """The channel-major blocks that ``_decode_kernel_v3`` builds (``_pe_block``, :307, and
    :339-360), written out in numpy from JAX's angles, against ``pe_front_end``."""
    inp = _inputs(40)
    spec = JaxCoordSpec(**SPEC)
    scales = np.array([1.0 / (spec.dx * (spec.lon_size - 1)), 1.0 / (spec.dy * (spec.lat_size - 1)),
                       1.0 / spec.pred_t_span], np.float32)
    cn = np.asarray(jnp.asarray(inp["coords"]) * jnp.asarray(scales))
    fb, fb2 = np.asarray(spec.freq_bands(), np.float32), j_bands(IN_CH // 12, 4.0)

    def block(x, bands):
        a = jnp.asarray(x)[:, None] * jnp.asarray(bands)
        return np.asarray(jnp.concatenate([jnp.sin(a), jnp.cos(a)], -1))

    pe = np.concatenate([block(cn[:, c], fb) for c in range(3)], -1)
    tang = np.stack([np.concatenate([np.asarray(jnp.cos(cn[:, k, None] * fb) * fb * scales[k]),
                                     np.asarray(-jnp.sin(cn[:, k, None] * fb) * fb * scales[k])], -1)
                     for k in range(3)])
    cd = np.concatenate([block(inp["cdata"][:, c], fb2) for c in range(6)], -1)
    got = tdk.pe_front_end(_t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC), IN_CH)
    for name, a, b in zip(("pe", "tangents", "cd"), got, (pe, tang, cd)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        # sin / cos of the same float32 angles in two libraries: a few ulp
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=4e-6 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("n", [64, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v3_plain_forward_matches_pallas_kernel(dtype, n):
    inp = _inputs(n)
    jw = _jax_side(inp)[0]
    p_k, t_k = jdk.fused_decode_jvp_v3(jw, jnp.asarray(inp["coords"]), jnp.asarray(inp["cdata"]),
                                       JaxCoordSpec(**SPEC), block_n=BLOCK, interpret=True,
                                       compute_dtype=getattr(jnp, dtype))
    w = _port_side(inp)[0]
    before = tdk.fused_decode_jvp_v3.launches
    p, t = tdk.fused_decode_jvp_v3(w, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC),
                                   getattr(torch, dtype))
    assert tdk.fused_decode_jvp_v3.launches == before
    assert tuple(p.shape) == (n, NV) and tuple(t.shape) == (3, n, NV)
    _assert_outputs_close(p, t, p_k, t_k)


def test_v3_is_v2_behind_the_front_end():
    """float32: v3 on raw values is v2 on the prepared PE (the conditioning values are
    v3's reference values), up to the order of the features in each sum."""
    inp = _inputs(64)
    w, pe, dpe, cd_pe, _ = _port_side(inp)
    p3, t3 = tdk.decode_jvp_v3_ref(w, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC), torch.float32)
    p2, t2 = tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, _t(inp["cdata"]), torch.float32)
    _assert_outputs_close(p3, t3, _np(p2), _np(t2))


def test_wrappers_raise_off_cpu_and_cuda_and_on_a_frequency_mismatch():
    inp = _inputs(8)
    w, pe, dpe, cd_pe, ref = _port_side(inp)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_decode_jvp(w, pe.to("meta"), dpe, cd_pe, ref, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_decode_jvp_v3(w, _t(inp["coords"]).to("meta"), _t(inp["cdata"]), CoordSpec(**SPEC),
                                torch.float32)
    other = CoordSpec(**dict(SPEC, n_freqs=F + 1))
    with pytest.raises(ValueError, match="implies 8 coordinate frequencies"):
        tdk.fused_decode_jvp_v3(w, _t(inp["coords"]), _t(inp["cdata"]), other, torch.float32)
    five = tdk.DecodeWeights(*(x[:5] for x in w))  # the conditioning values are 6 reference values
    with pytest.raises(ValueError, match="got 5 variables"):
        tdk.fused_decode_jvp_v3(five, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC), torch.float32)


# ---- the engine's version-2 routes -----------------------------------------------------------

@pytest.mark.parametrize("trainable", [False, True])
def test_fused_kernel_fields_v2_matches_jax(world, trainable):  # noqa: F811
    """JAX: the v2 Pallas kernel in interpret mode (forward only) or, trainable, its XLA twin
    (off the TPU ``fused_decode_jvp_trainable`` is the twin alone, :1842-1845).  Port: the
    kernel's plain version, through ``FusedDecodeJvpV2`` when trainable.  float32."""
    p_j, t_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"], interpret=True,
                                           trainable=trainable, version=2, raw_tangents=True)
    p_t, t_t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                           trainable=trainable, version=2, raw_tangents=True)
    if trainable:
        assert type(p_t.grad_fn).__name__ == "FusedDecodeJvpV2Backward"
    _assert_outputs_close(p_t, t_t, p_j, t_j)


def test_fused_residual_losses_v2_dispatches_at_the_crossover(world, monkeypatch):  # noqa: F811
    """Both sides of ``FUSED_ASSEMBLY_MIN_N``, in both packages: below it the split path of
    the v2 forward kernel and the dict-form assembly (:692-696), at or above it the
    in-kernel assembly with the v4 layer 1, which every version but 6 takes (:665)."""
    n = 64
    w = dict(world, coords=world["coords"][:n], nwp=world["nwp"][:n])
    f = world["f"][:n]
    calls = {"v2": 0, "residual": []}
    split_fn, residual_fn = tengine.fused_decode_jvp, tengine.kernel_residual_losses
    monkeypatch.setattr(tengine, "fused_decode_jvp",
                        lambda *a: calls.__setitem__("v2", calls["v2"] + 1) or split_fn(*a))
    monkeypatch.setattr(tengine, "kernel_residual_losses",
                        lambda *a, **k: calls["residual"].append(k["version"]) or residual_fn(*a, **k))
    out = {}
    for side, min_n in (("split", 10**9), ("fused", n)):
        monkeypatch.setattr(jengine, "FUSED_ASSEMBLY_MIN_N", min_n)
        monkeypatch.setattr(tengine, "FUSED_ASSEMBLY_MIN_N", min_n)
        want = jengine.fused_residual_losses(*_j_args(w), jnp.asarray(f), w["jspec"], w["jspecs"], FACTORS,
                                             interpret=True, version=2)
        got = tengine.fused_residual_losses(*_t_args(w), torch.from_numpy(f), w["tspec"], w["tspecs"],
                                            FACTORS, version=2)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-3, err_msg=f"{side} {k}")
        out[side] = got
    assert calls == {"v2": 1, "residual": [2]}
    # the v4 residual kernel is the v4 function, which is v2's: the two sides agree
    for k, v in out["split"].items():
        np.testing.assert_allclose(float(out["fused"][k]), float(v), rtol=1e-3, err_msg=k)


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


def _card_weights(dev, rng, in_ch=192, hid=256):
    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(dev)

    return tdk.DecodeWeights(w1=r(6, in_ch, hid), b1=r(6, hid), w2=r(6, hid, hid), b2=r(6, hid),
                             wd=r(6, in_ch, hid), bd=r(6, hid), fh_add=r(6, hid), f1=r(6, hid, hid),
                             g1=r(6, hid), f2=r(6, hid, hid), g2=r(6, hid), wo=r(6, hid), bo=r(6))


# The point-block edges of the v2 kernel (64 points a block), the size of the test's first form
# and the step's larger launch
CARD_SIZES = (1, 17, 64, 65, 129, 1000, 20480)
# chip_smoke.py's rule for relu kinks: the points at which a relu argument (z or r) of the plain
# version lies within KINK_EPS (1 + the largest argument) of zero, where another summation order may
# switch a tangent term on or off, are left out of the comparison
KINK_EPS = 2e-6


def _amax(x):
    """max |x|, 0 for no element (every point near a kink)."""
    return float(x.abs().max()) if x.numel() else 0.0


def _near_kink(w, pe, cd_pe, dtype):
    z = tdk.dot_f32(pe, w.w1, dtype) + w.b1[:, None, :]
    c = (tdk.dot_f32(torch.relu(z), w.w2, dtype) + w.b2[:, None, :]
         + (tdk.dot_f32(cd_pe, w.wd, dtype) + w.bd[:, None, :]) + w.fh_add[:, None, :])
    r = tdk.dot_f32(c, w.f1, dtype) + w.g1[:, None, :]
    return ((z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
            | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_and_v3_kernels_match_plain(cuda_device, dtype):
    """The two CUDA kernels against their plain versions at the kernels' widths and CARD_SIZES,
    with the bounds of chip_smoke.py, the points near a relu kink left out."""
    rng = np.random.RandomState(12)
    n_max, td = max(CARD_SIZES), getattr(torch, dtype)
    w = _card_weights(cuda_device, rng)
    spec = CoordSpec(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
    coords_all = torch.from_numpy(np.stack([rng.rand(n_max) * 27000 * 256, rng.rand(n_max) * 27000 * 144,
                                            rng.rand(n_max) * 86400.0], -1).astype(np.float32)).to(cuda_device)
    cdata_all = torch.from_numpy((rng.randn(n_max, 6) * 0.3).astype(np.float32)).to(cuda_device)
    perms = [torch.as_tensor(tdk.channel_major_perm(192, c), device=cuda_device) for c in (3, 6)]
    tol = 1e-5 if dtype == "float32" else 1e-3
    for n in CARD_SIZES:
        coords, cdata = coords_all[:n].contiguous(), cdata_all[:n].contiguous()
        pe, dpe = tdk.pe_and_tangents(coords, spec, td)
        cd_pe = sinecos_pe(cdata, make_freq_bands(16, 4.0)).to(td)
        before = tdk.fused_decode_jvp.launches, tdk.fused_decode_jvp_v3.launches
        outs = {"v2": tdk.fused_decode_jvp(w, pe, dpe, cd_pe, cdata, td),
                "v3": tdk.fused_decode_jvp_v3(w, coords, cdata, spec, td)}
        torch.cuda.synchronize()
        assert (tdk.fused_decode_jvp.launches, tdk.fused_decode_jvp_v3.launches) == (before[0] + 1, before[1] + 1)
        plain = {"v2": tdk.decode_jvp_v2_ref(w, pe, dpe, cd_pe, cdata, td),
                 "v3": tdk.decode_jvp_v3_ref(w, coords, cdata, spec, td)}
        # the kink points from the operands each plain version computes: v3's channel-major PE in f32
        pe3, _, cd3 = tdk.pe_front_end(coords, cdata, spec, 192)
        near = {"v2": _near_kink(w, pe, cd_pe, td),
                "v3": _near_kink(w._replace(w1=w.w1[:, perms[0]], wd=w.wd[:, perms[1]]), pe3.to(td), cd3.to(td), td)}
        for k, (p, t) in outs.items():
            p0, t0 = plain[k]
            keep = ~near[k]
            p, t, p0, t0 = p[keep], t[:, keep], p0[keep], t0[:, keep]
            assert _amax(p - p0) <= tol * (1.0 + _amax(p0)), (k, n)
            for d in range(3):
                assert _amax(t[d] - t0[d]) <= 10 * tol * _amax(t0[d]), (k, n)
