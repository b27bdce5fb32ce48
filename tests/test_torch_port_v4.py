"""PyTorch port against the JAX package: the v4 / v4t decode pair.

The same numpy inputs, made from a seed, go through the JAX functions of
``deepphysinet_tpu/ops/decode_kernel.py`` and their counterparts in
``deepphysinet_tpu_torch/ops/decode_kernel.py``.  The Pallas kernels run as the
JAX package's own tests run them on the CPU, in interpret mode.  On the CPU the
port's wrappers take their plain versions, which is what these tests hold to
JAX; the CUDA kernels are held to the same plain versions on the card (the
test marked ``cuda`` here, and ``chip_smoke.py``).

Which JAX function each plain version is held to:

* float32: the plain forward against the XLA twin ``decode_jvp_xla_v4`` at rtol
  1e-5 (no rounding anywhere, so twin and kernel are the same function) and
  against the Pallas kernels of both layouts; the plain backward against the
  Pallas backward kernels per weight at 5e-4 of that weight's largest
  cotangent, the bar of tests/test_decode_kernel_v4t.py;
* bfloat16: the Pallas kernels only.  The forward kernel stores the masked
  tangents in bf16 and its XLA twin does not; the port's plain forward copies
  the kernel's rounding, and with ``round_tangents=False`` the twin's.  The
  backward kernel keeps the recomputed tangents float32 where the forward
  rounds them; the plain backward does the same, and a test pins the difference.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.ops import decode_kernel as jdk
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec

from deepphysinet_tpu_torch.ops import decode_kernel as tdk
from deepphysinet_tpu_torch.ops.coords import CoordSpec

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

F, HID, NV = 8, 32, 6
IN_CH, CH = 6 * F, 2 * F
BLOCK = 128
SPEC = dict(lon_size=17, lat_size=9, dx=27000.0, dy=27000.0, pred_t_span=86400.0, n_freqs=F)
FIELDS = tdk.FusedDecodeWeights._fields
LAYOUTS = pytest.mark.parametrize("t_layout", [False, True], ids=["point_major", "var_major"])


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(n, seed=7):
    """Decode weights, coordinates, cd PE, reference values and cotangents as numpy
    (the per-point arrays var-major; the tests transpose them for the other layout)."""
    rng = np.random.RandomState(seed)

    def r(*s, scale=0.3):
        return (rng.randn(*s) * scale).astype(np.float32)

    w = dict(w1=r(NV, IN_CH, HID), b1=r(NV, HID), w2=r(NV, HID, HID), b2=r(NV, HID),
             wd=r(NV, IN_CH, HID), bd=r(NV, HID), fh_add=r(NV, HID), f1=r(NV, HID, HID),
             g1=r(NV, HID), f2=r(NV, HID, HID), g2=r(NV, HID), wo=r(NV, HID), bo=r(NV))
    coords = np.stack([rng.rand(n) * 27000 * (SPEC["lon_size"] - 1),
                       rng.rand(n) * 27000 * (SPEC["lat_size"] - 1),
                       rng.randint(0, 25, n) * 3600.0], -1).astype(np.float32)
    return dict(w=w, coords=coords, cd_pe=r(n, IN_CH), ref_t=r(NV, n),
                g_p=r(NV, n, scale=1.0), g_t=r(3, NV, n, scale=1.0))


def _layout(primal_t, tang_t, t_layout):
    """Var-major numpy arrays in the requested layout."""
    if t_layout:
        return primal_t, tang_t
    return np.ascontiguousarray(primal_t.T), np.ascontiguousarray(tang_t.transpose(0, 2, 1))


def _jax_side(inp, dtype):
    fw = jdk.fuse_decode_weights(jdk.DecodeWeights(**{k: jnp.asarray(v) for k, v in inp["w"].items()}))
    pe, dpe = jdk.pe_and_tangents(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC), getattr(jnp, dtype))
    return fw, pe, dpe, jnp.asarray(inp["cd_pe"])


def _port_side(inp, dtype):
    fw = tdk.fuse_decode_weights(tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()}))
    td = getattr(torch, dtype)
    pe, dpe = tdk.pe_and_tangents(_t(inp["coords"]), CoordSpec(**SPEC), td)
    return fw, pe, dpe, _t(inp["cd_pe"]).to(td)


# ---- prep: PE with tangents, tangent weight slices --------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_and_tangents_matches_jax(dtype):
    inp = _inputs(300)
    pe_j, dpe_j = jdk.pe_and_tangents(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC), getattr(jnp, dtype))
    pe, dpe = tdk.pe_and_tangents(_t(inp["coords"]), CoordSpec(**SPEC), getattr(torch, dtype))
    assert tuple(pe.shape) == (300, IN_CH) and tuple(dpe.shape) == (3, 300, CH)
    assert pe.dtype == dpe.dtype == getattr(torch, dtype)
    # sin/cos of arguments up to 16: a few float32 ulp; one bf16 ulp (2^-8 relative)
    # where such a difference crosses a rounding boundary.  The tangents carry
    # f / (dx (lon - 1)) ~ 1e-6, so they are held relative to their largest value
    rel = 2e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(pe), np.asarray(pe_j.astype(jnp.float32)), rtol=0, atol=rel)
    want = np.asarray(dpe_j.astype(jnp.float32))
    for k in range(3):
        np.testing.assert_allclose(_np(dpe[k]), want[k], rtol=0, atol=rel * np.abs(want[k]).max())
    # the primal half alone is the same array
    np.testing.assert_array_equal(_np(tdk.pe_primal(_t(inp["coords"]), CoordSpec(**SPEC),
                                                    getattr(torch, dtype))), _np(pe))


def test_slice_tangent_weights_and_fusion_match_jax():
    inp = _inputs(4)
    want, _, _, _ = _jax_side(inp, "float32")
    got, _, _, _ = _port_side(inp, "float32")
    assert FIELDS == jdk.FusedDecodeWeights._fields
    np.testing.assert_array_equal(_np(tdk.slice_tangent_weights(_t(inp["w"]["w1"]))),
                                  np.asarray(jdk.slice_tangent_weights(jnp.asarray(inp["w"]["w1"]))))
    # slice k holds rows k, k+3, ... of w1
    np.testing.assert_array_equal(_np(got.w1c[:, 1]), inp["w"]["w1"][:, 1::3])
    for name in FIELDS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6 * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)


# ---- the plain forward -------------------------------------------------------------------

@pytest.mark.parametrize("round_tangents", [True, False])
def test_plain_forward_matches_xla_twin_f32(round_tangents):
    inp = _inputs(300)
    fw_j, pe_j, dpe_j, cd_j = _jax_side(inp, "float32")
    p_x, t_x = jdk.decode_jvp_xla_v4(fw_j, pe_j, dpe_j, cd_j, jnp.asarray(inp["ref_t"].T), jnp.float32)
    fw_t, pe_t, dpe_t, cd_t = _port_side(inp, "float32")
    p, t = tdk.decode_jvp_v4_ref(fw_t, pe_t, dpe_t, cd_t, _t(inp["ref_t"].T), torch.float32,
                                 round_tangents)
    assert tuple(p.shape) == (300, NV) and tuple(t.shape) == (3, 300, NV)
    # tangents carry the scales 1 / (dx (lon - 1)): absolute floor at their magnitude
    np.testing.assert_allclose(_np(p), np.asarray(p_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t), np.asarray(t_x), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(t_x))))


def _first_points(inp, n):
    """The first n points of ``_inputs``' per-point arrays (the weights unchanged)."""
    return dict(inp, coords=inp["coords"][:n], cd_pe=inp["cd_pe"][:n], ref_t=inp["ref_t"][:, :n],
                g_p=inp["g_p"][:, :n], g_t=inp["g_t"][:, :, :n])


@functools.lru_cache(maxsize=None)
def _pallas_forward_300(dtype, t_layout):
    """The Pallas forward kernel (interpret mode) on the 300 points of ``_inputs(300)``, once
    per dtype and layout: each point's outputs depend on its own inputs only, so a case at
    n points reads the first n of them."""
    inp = _inputs(300)
    ref, _ = _layout(inp["ref_t"], inp["g_t"], t_layout)
    fw_j, pe_j, dpe_j, cd_j = _jax_side(inp, dtype)
    j_fn = jdk.fused_decode_jvp_v4t if t_layout else jdk.fused_decode_jvp_v4
    p_k, t_k = j_fn(fw_j, pe_j, dpe_j, cd_j, jnp.asarray(ref), block_n=BLOCK, interpret=True,
                    compute_dtype=getattr(jnp, dtype))
    return np.asarray(p_k), np.asarray(t_k)


# 1, 17, 64, 65, 129: the point-block edges of the port's tensor-core kernels (64 points a
# block), where chip_smoke.py holds them to these plain versions
EDGE_SIZES = [300, 3, 1, 17, 64, 65, 129]


@LAYOUTS
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_kernel(dtype, n, t_layout):
    inp = _first_points(_inputs(300), n)
    ref, _ = _layout(inp["ref_t"], inp["g_t"], t_layout)
    p_k, t_k = _pallas_forward_300(dtype, t_layout)
    p_k, t_k = (p_k[:, :n], t_k[:, :, :n]) if t_layout else (p_k[:n], t_k[:, :n])
    fw_t, pe_t, dpe_t, cd_t = _port_side(inp, dtype)
    # the wrapper, which takes the plain version on CPU tensors
    t_fn = tdk.fused_decode_jvp_v4t if t_layout else tdk.fused_decode_jvp_v4
    before = t_fn.launches
    p, t = t_fn(fw_t, pe_t, dpe_t, cd_t, _t(ref), getattr(torch, dtype))
    assert t_fn.launches == before  # no kernel was launched
    assert tuple(p.shape) == p_k.shape and tuple(t.shape) == t_k.shape and p.dtype == torch.float32
    # same rounding points on both sides.  float32: summation order, the bar of
    # tests/test_decode_kernel_v4t.py.  bfloat16: pe and dpe may differ by one bf16
    # ulp between XLA and torch (see test_pe_and_tangents_matches_jax), and a
    # summation-order difference can flip the rounding of p or of a tangent
    # (2^-9 relative of one of 32 terms), hence 2e-3 of the largest output
    tol = 2e-4 if dtype == "float32" else 2e-3
    for got, want in ((p, p_k), (t, t_k)):
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max())


def test_plain_forward_bf16_twin_rounding_differs_from_kernel_rounding():
    """``round_tangents`` selects between the kernel's and the XLA twin's rounding."""
    inp = _inputs(300)
    fw_j, pe_j, dpe_j, cd_j = _jax_side(inp, "bfloat16")
    _, t_x = jdk.decode_jvp_xla_v4(fw_j, pe_j, dpe_j, cd_j.astype(jnp.bfloat16),
                                   jnp.asarray(inp["ref_t"].T), jnp.bfloat16)
    fw_t, pe_t, dpe_t, cd_t = _port_side(inp, "bfloat16")
    ref = _t(inp["ref_t"].T)
    _, t_twin = tdk.decode_jvp_v4_ref(fw_t, pe_t, dpe_t, cd_t, ref, torch.bfloat16, round_tangents=False)
    _, t_kern = tdk.decode_jvp_v4_ref(fw_t, pe_t, dpe_t, cd_t, ref, torch.bfloat16, round_tangents=True)
    scale = float(jnp.max(jnp.abs(t_x)))
    np.testing.assert_allclose(_np(t_twin), np.asarray(t_x), rtol=2e-3, atol=2e-3 * scale)
    assert float((t_twin - t_kern).abs().max()) > 0.0


def test_layouts_are_transposes_of_each_other():
    """One function, two layouts: the outputs and the cotangents' effects are equal bit for bit."""
    inp = _inputs(300)
    fw, pe, dpe, cd = _port_side(inp, "bfloat16")
    p_t, t_t = tdk.fused_decode_jvp_v4t(fw, pe, dpe, cd, _t(inp["ref_t"]), torch.bfloat16)
    p_n, t_n = tdk.fused_decode_jvp_v4(fw, pe, dpe, cd, _t(inp["ref_t"].T), torch.bfloat16)
    assert torch.equal(p_n.t(), p_t) and torch.equal(t_n.transpose(1, 2), t_t)
    g_p, g_t = _layout(inp["g_p"], inp["g_t"], False)
    a = tdk.decode_bwd_kernel_v4t(fw, pe, dpe, cd, _t(inp["g_p"]), _t(inp["g_t"]), torch.bfloat16)
    b = tdk.decode_bwd_kernel_v4(fw, pe, dpe, cd, _t(g_p), _t(g_t), torch.bfloat16)
    for name in FIELDS[:-1]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    # g_obias is a torch.sum over the other axis of the other layout: another order
    torch.testing.assert_close(a.obias, b.obias, rtol=1e-5, atol=0)


# ---- the plain backward ------------------------------------------------------------------

def _assert_cotangents_close(got, want, tol):
    """Per weight, relative to that weight's own largest cotangent."""
    for name in FIELDS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


@functools.lru_cache(maxsize=None)
def _pallas_backward_300(dtype, t_layout):
    """The Pallas backward kernel (interpret mode) on the 300 points of ``_inputs(300)``, traced
    and compiled once per dtype and layout; called with cotangents that are zero past the first
    n points it gives the cotangents of those n points (every output is linear in the
    cotangents, point by point)."""
    fw_j, pe_j, dpe_j, cd_j = _jax_side(_inputs(300), dtype)
    j_fn = jdk.decode_bwd_kernel_v4t if t_layout else jdk.decode_bwd_kernel_v4
    run = jax.jit(functools.partial(j_fn, block_n=BLOCK, interpret=True, compute_dtype=getattr(jnp, dtype)))
    return lambda g_p, g_t: run(fw_j, pe_j, dpe_j, cd_j, jnp.asarray(g_p), jnp.asarray(g_t))


@LAYOUTS
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_kernel(dtype, n, t_layout):
    full = _inputs(300)
    live = np.arange(300) < n
    want = _pallas_backward_300(dtype, t_layout)(*_layout(np.where(live, full["g_p"], 0.0).astype(np.float32),
                                                          np.where(live, full["g_t"], 0.0).astype(np.float32),
                                                          t_layout))
    inp = _first_points(full, n)
    g_p, g_t = _layout(inp["g_p"], inp["g_t"], t_layout)
    fw_t, pe_t, dpe_t, cd_t = _port_side(inp, dtype)
    t_fn = tdk.decode_bwd_kernel_v4t if t_layout else tdk.decode_bwd_kernel_v4
    before = t_fn.launches
    got = t_fn(fw_t, pe_t, dpe_t, cd_t, _t(g_p), _t(g_t), getattr(torch, dtype))
    assert t_fn.launches == before
    # float32: the bar of tests/test_decode_kernel_v4t.py.  bfloat16: both sides
    # round every product operand at the same places; what is left is the one-ulp
    # difference of pe / dpe and rounding flips of operands (2^-9 relative each)
    _assert_cotangents_close(got, want, 5e-4 if dtype == "float32" else 5e-3)


def test_plain_backward_matches_autograd_of_plain_forward():
    """float32: the hand-derived backward is the gradient of the plain forward."""
    inp = _inputs(300)
    fw, pe, dpe, cd = _port_side(inp, "float32")
    g_p, g_t = _t(inp["g_p"]), _t(inp["g_t"])
    got = tdk.decode_bwd_v4_ref(fw, pe, dpe, cd, g_p, g_t, torch.float32, t_layout=True)
    leaves = tdk.FusedDecodeWeights(*(w.clone().requires_grad_(True) for w in fw))
    p, t = tdk.decode_jvp_v4_ref(leaves, pe, dpe, cd, torch.zeros(NV, 300), torch.float32, t_layout=True)
    ((p * g_p).sum() + (t * g_t).sum()).backward()
    _assert_cotangents_close(got, tdk.FusedDecodeWeights(*(w.grad for w in leaves)), 1e-4)


def test_backward_keeps_tangents_f32_where_the_forward_rounds_them():
    """bfloat16: the backward kernel's ``w2wo`` and ``fw2`` sums read the recomputed
    tangents unrounded (decode_kernel.py:1472, :1494-1495) while the forward kernel
    reads them rounded (:578-579), so the backward is the gradient of the forward
    with ``round_tangents=False`` in those two sums, not of the kernel's forward."""
    inp = _inputs(300)
    fw, pe, dpe, cd = _port_side(inp, "bfloat16")
    g_p, g_t = torch.zeros(NV, 300), _t(inp["g_t"])  # tangent cotangents only
    got = tdk.decode_bwd_v4_ref(fw, pe, dpe, cd, g_p, g_t, torch.bfloat16, t_layout=True)

    def w2wo_grad(round_tangents):
        leaf = fw.w2wo.clone().requires_grad_(True)
        _, t = tdk.decode_jvp_v4_ref(fw._replace(w2wo=leaf), pe, dpe, cd, torch.zeros(NV, 300),
                                     torch.bfloat16, round_tangents, t_layout=True)
        (t * g_t).sum().backward()
        return leaf.grad

    unrounded, rounded = w2wo_grad(False), w2wo_grad(True)
    scale = float(unrounded.abs().max())
    assert float((got.w2wo - unrounded).abs().max()) <= 1e-5 * scale
    assert float((got.w2wo - rounded).abs().max()) > 1e-4 * scale


# ---- the autograd.Function ---------------------------------------------------------------

@LAYOUTS
def test_autograd_function_matches_jax_grad_through_pallas_pair(t_layout):
    """Gradients of a scalar of the outputs with respect to the fused weights and
    ``ref``, against ``jax.grad`` through the custom-vjp pair in interpret mode."""
    inp = _inputs(300)
    ref, _ = _layout(inp["ref_t"], inp["g_t"], t_layout)
    g_p, g_t = _layout(inp["g_p"], inp["g_t"], t_layout)
    fw_j, pe_j, dpe_j, cd_j = _jax_side(inp, "float32")
    j_fn = jdk.fused_decode_jvp_v4t_kbwd if t_layout else jdk.fused_decode_jvp_v4_kbwd

    def j_loss(fw, pe, dpe, cd, r):
        p, t = j_fn(fw, pe, dpe, cd, r, BLOCK, jnp.float32, True)
        return jnp.sum(p * jnp.asarray(g_p)) + jnp.sum(t * jnp.asarray(g_t))

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(fw_j, pe_j, dpe_j, cd_j, jnp.asarray(ref))
    fw_t, pe_t, dpe_t, cd_t = _port_side(inp, "float32")
    leaves = tdk.FusedDecodeWeights(*(w.clone().requires_grad_(True) for w in fw_t))
    points = [x.clone().requires_grad_(True) for x in (pe_t, dpe_t, cd_t, _t(ref))]
    t_fn = tdk.fused_decode_jvp_v4t_kbwd if t_layout else tdk.fused_decode_jvp_v4_kbwd
    p, t = t_fn(leaves, *points, torch.float32)
    ((p * _t(g_p)).sum() + (t * _t(g_t)).sum()).backward()
    _assert_cotangents_close(tdk.FusedDecodeWeights(*(w.grad for w in leaves)), want[0], 5e-4)
    # o = ... + ref: the identity head; pe, dpe and cd_pe are data: zeros by contract
    np.testing.assert_array_equal(_np(points[3].grad), g_p)
    np.testing.assert_array_equal(np.asarray(want[4]), g_p)
    for got, jax_zero in zip(points[:3], want[1:4]):
        assert got.grad.shape == got.shape and not got.grad.any()
        assert not np.asarray(jax_zero).any()


def test_autograd_function_saves_no_activations():
    inp = _inputs(64)
    fw, pe, dpe, cd = _port_side(inp, "float32")
    leaves = tdk.FusedDecodeWeights(*(w.clone().requires_grad_(True) for w in fw))
    p, _ = tdk.fused_decode_jvp_v4t_kbwd(leaves, pe, dpe, cd, _t(inp["ref_t"]), torch.float32)
    saved = p.grad_fn.saved_tensors
    assert len(saved) == 3 + len(FIELDS)
    assert {tuple(s.shape) for s in saved} == (
        {tuple(pe.shape), tuple(dpe.shape), tuple(cd.shape)} | {tuple(w.shape) for w in fw})


def test_w1c_cotangent_reaches_w1_through_the_slice():
    """``w1c`` is a row slice of ``w1``: autograd adds its cotangent into ``w1``'s."""
    inp = _inputs(64)
    _, pe, dpe, cd = _port_side(inp, "float32")
    dw = tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()})
    w1 = dw.w1.clone().requires_grad_(True)
    fw = tdk.fuse_decode_weights(dw._replace(w1=w1))
    p, t = tdk.fused_decode_jvp_v4t_kbwd(fw, pe, dpe, cd, _t(inp["ref_t"]), torch.float32)
    ((p * _t(inp["g_p"])).sum() + (t * _t(inp["g_t"])).sum()).backward()
    g = tdk.decode_bwd_v4_ref(fw, pe, dpe, cd, _t(inp["g_p"]), _t(inp["g_t"]), torch.float32, t_layout=True)
    want = g.w1.clone()
    for k in range(3):
        want[:, k::3] += g.w1c[:, k]
    np.testing.assert_allclose(_np(w1.grad), _np(want), rtol=1e-6, atol=1e-7 * float(want.abs().max()))


def test_wrappers_have_no_kernel_off_cpu_and_cuda():
    inp = _inputs(8)
    fw, pe, dpe, cd = _port_side(inp, "float32")
    for fn, ref in ((tdk.fused_decode_jvp_v4, _t(inp["ref_t"].T)), (tdk.fused_decode_jvp_v4t, _t(inp["ref_t"]))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(fw, pe.to("meta"), dpe, cd, ref, torch.float32)
    for fn in (tdk.decode_bwd_kernel_v4, tdk.decode_bwd_kernel_v4t):
        with pytest.raises(ValueError, match="no kernel"):
            fn(fw, pe.to("meta"), dpe, cd, _t(inp["g_p"]), _t(inp["g_t"]), torch.float32)
    # the TPU's software-pipelined body is an instruction order, not an option of the port
    with pytest.raises(TypeError, match="pipeline"):
        tdk.fused_decode_jvp_v4t(fw, pe, dpe, cd, _t(inp["ref_t"]), torch.float32, pipeline=True)


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


# The point-block edges of the tensor-core kernels (64 points a block), the size of a test above,
# the step's larger launch and one 145 x 257 frame (the forward's)
CARD_SIZES = (1, 17, 64, 65, 129, 1000, 20480, 37265)
# chip_smoke.py's rule for relu kinks: the points at which a relu argument of the plain version
# lies within KINK_EPS (1 + the largest argument) of zero, where another summation order may
# switch a tangent term on or off, are left out of the forward's comparison
KINK_EPS = 2e-6


def _near_kink(fw, pe, cd, dtype):
    z = tdk.dot_f32(pe, fw.w1, dtype) + fw.b1[:, None, :]
    near = (z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
    r = tdk.dot_f32(torch.relu(z), fw.w2f1, dtype) + tdk.dot_f32(cd, fw.wdf1, dtype) + fw.rbias[:, None, :]
    return near | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0)


@pytest.mark.cuda
@LAYOUTS
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v4_kernels_match_plain(cuda_device, dtype, t_layout):
    """The two CUDA kernels against their plain versions at the kernels' widths: the forward at
    CARD_SIZES, its two layouts bit-equal; the backward at the same sizes but the frame, the
    cotangents of the points near a relu kink zero (chip_smoke.py's rule)."""
    rng = np.random.RandomState(11)
    in_ch, hid = 192, 256
    td = getattr(torch, dtype)

    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(cuda_device)

    w1 = r(6, in_ch, hid)
    fw = tdk.FusedDecodeWeights(
        w1=w1, w1c=tdk.slice_tangent_weights(w1), b1=r(6, hid), w2f1=r(6, hid, hid),
        wdf1=r(6, in_ch, hid), rbias=r(6, hid), fw2=r(6, hid), w2wo=r(6, hid), wdwo=r(6, in_ch),
        obias=r(6))
    n_max = max(CARD_SIZES)
    pe_all, cd_all = r(n_max, in_ch, scale=1.0).to(td), r(n_max, in_ch, scale=1.0).to(td)
    dpe_all, ref_all = r(3, n_max, in_ch // 3, scale=1e-3).to(td), r(6, n_max)
    fwd, other = ((tdk.fused_decode_jvp_v4t, tdk.fused_decode_jvp_v4) if t_layout
                  else (tdk.fused_decode_jvp_v4, tdk.fused_decode_jvp_v4t))
    # the bounds of chip_smoke.py
    tol = 1e-5 if dtype == "float32" else 1e-3
    for n in CARD_SIZES:
        pe, cd, dpe = pe_all[:n].contiguous(), cd_all[:n].contiguous(), dpe_all[:, :n].contiguous()
        ref_t = ref_all[:, :n].contiguous()
        before = fwd.launches
        p, t = fwd(fw, pe, dpe, cd, ref_t if t_layout else ref_t.t().contiguous(), td)
        p_o, t_o = other(fw, pe, dpe, cd, ref_t.t().contiguous() if t_layout else ref_t, td)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        if t_layout:  # both var-major from here
            p_o, t_o = p_o.t(), t_o.transpose(1, 2)
        else:
            p, t = p.t(), t.transpose(1, 2)
        assert torch.equal(p, p_o) and torch.equal(t, t_o), n  # the layouts give the same bits
        p0, t0 = tdk.decode_jvp_v4_ref(fw, pe, dpe, cd, ref_t, td, t_layout=True)
        keep = ~_near_kink(fw, pe, cd, td)
        p, t, p0, t0 = p[:, keep], t[:, :, keep], p0[:, keep], t0[:, :, keep]
        assert float((p - p0).abs().max()) <= tol * (1.0 + float(p0.abs().max())), n
        for k in range(3):
            assert float((t[k] - t0[k]).abs().max()) <= tol * float(t0[k].abs().max()), (n, k)

    bwd = tdk.decode_bwd_kernel_v4t if t_layout else tdk.decode_bwd_kernel_v4
    for n in CARD_SIZES[:-1]:
        pe, cd, dpe = pe_all[:n].contiguous(), cd_all[:n].contiguous(), dpe_all[:, :n].contiguous()
        g_p, g_t = r(6, n, scale=1.0), r(3, 6, n, scale=1.0)  # var-major
        near = _near_kink(fw, pe, cd, td)
        g_p[:, near], g_t[:, :, near] = 0.0, 0.0
        if not t_layout:
            g_p, g_t = g_p.t().contiguous(), g_t.transpose(1, 2).contiguous()
        before = bwd.launches
        g = bwd(fw, pe, dpe, cd, g_p, g_t, td)
        torch.cuda.synchronize()
        assert bwd.launches == before + 1
        _assert_cotangents_close(g, tdk.decode_bwd_v4_ref(fw, pe, dpe, cd, g_p, g_t, td, t_layout),
                                 1e-4 if dtype == "float32" else 2e-3)
