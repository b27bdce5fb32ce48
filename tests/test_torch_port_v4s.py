"""PyTorch port against the JAX package: the v4s decode pair of the training step.

The same numpy inputs, made from a seed, go through the JAX functions of
``deepphysinet_tpu/ops/decode_kernel.py`` and their counterparts in
``deepphysinet_tpu_torch/ops/decode_kernel.py``.  The Pallas kernels run as the
JAX package's own tests run them on the CPU, in interpret mode.  On the CPU the
port's wrappers take their plain versions, which is what these tests hold to
JAX; the CUDA kernels are held to the same plain versions on the card (the
test marked ``cuda`` here, and ``chip_smoke.py``).

Which JAX function each plain version is held to:

* float32: the plain forward against the XLA twin ``decode_jvp_xla_v4s`` at
  rtol 1e-5 (no rounding anywhere, so twin and kernel are the same function)
  and against the Pallas kernel; the plain backward against the Pallas backward
  kernel per weight at 5e-4 of that weight's largest cotangent, the bar of
  tests/test_decode_kernel_v4s.py;
* bfloat16: the Pallas kernels only.  The forward kernel stores the masked
  tangents in bf16 and its XLA twin does not (they differ by up to 2e-2,
  tests/test_decode_kernel_v4s.py:107-110); the port's plain forward copies the
  kernel's rounding, and with ``round_tangents=False`` the twin's.
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
IN_CH, TWO_F = 6 * F, 2 * F
BLOCK = 128
SPEC = dict(lon_size=17, lat_size=9, dx=27000.0, dy=27000.0, pred_t_span=86400.0, n_freqs=F)
FIELDS = tdk.FusedDecodeWeightsV6._fields


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(n, seed=7):
    """Decode weights, coordinates, cd PE, reference values and cotangents as numpy."""
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


def _jax_side(inp, dtype):
    fw6 = jdk.fuse_v6_from_v4(jdk.fuse_decode_weights(
        jdk.DecodeWeights(**{k: jnp.asarray(v) for k, v in inp["w"].items()})), JaxCoordSpec(**SPEC))
    pe_cm = jdk.trig_cm_inputs(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC), getattr(jnp, dtype))
    return fw6, pe_cm, jnp.asarray(inp["cd_pe"]), jnp.asarray(inp["ref_t"])


def _port_side(inp, dtype):
    fw6 = tdk.fuse_v6_from_v4(tdk.fuse_decode_weights(
        tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()})), CoordSpec(**SPEC))
    td = getattr(torch, dtype)
    pe_cm = tdk.trig_cm_inputs(_t(inp["coords"]), CoordSpec(**SPEC), td)
    return fw6, pe_cm, _t(inp["cd_pe"]).to(td), _t(inp["ref_t"])


# ---- prep: trig operand and weight folding -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trig_cm_inputs_matches_jax(dtype):
    inp = _inputs(300)
    want = jdk.trig_cm_inputs(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC), getattr(jnp, dtype))
    got = tdk.trig_cm_inputs(_t(inp["coords"]), CoordSpec(**SPEC), getattr(torch, dtype))
    assert tuple(got.shape) == (300, IN_CH) and got.dtype == getattr(torch, dtype)
    # sin/cos of arguments up to 16: a few float32 ulp; one bf16 ulp (2^-8) where
    # such a difference crosses a rounding boundary
    atol = 2e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=0, atol=atol)
    np.testing.assert_array_equal(tdk.channel_major_perm(IN_CH, 3), jdk.channel_major_perm(IN_CH, 3))
    np.testing.assert_array_equal(_np(tdk.coord_scales(CoordSpec(**SPEC))),
                                  np.asarray(jdk.coord_scales(JaxCoordSpec(**SPEC))))


def test_fuse_v6_from_v4_matches_jax():
    inp = _inputs(4)
    want, _, _, _ = _jax_side(inp, "float32")
    got, _, _, _ = _port_side(inp, "float32")
    for name in FIELDS:
        a, b = _np(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6 * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)


# ---- the plain forward -----------------------------------------------------------

@pytest.mark.parametrize("round_tangents", [True, False])
def test_plain_forward_matches_xla_twin_f32(round_tangents):
    inp = _inputs(300)
    fw_j, pe_j, cd_j, ref_j = _jax_side(inp, "float32")
    p_x, t_x = jdk.decode_jvp_xla_v4s(fw_j, pe_j, cd_j, ref_j, jnp.float32)
    fw_t, pe_t, cd_t, ref_t = _port_side(inp, "float32")
    p, t = tdk.decode_jvp_v4s_ref(fw_t, pe_t, cd_t, ref_t, torch.float32, round_tangents)
    assert tuple(p.shape) == (NV, 300) and tuple(t.shape) == (3, NV, 300)
    # tangents carry the folded scales 1 / (dx (lon - 1)): absolute floor at their magnitude
    np.testing.assert_allclose(_np(p), np.asarray(p_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t), np.asarray(t_x), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(t_x))))


def _first_points(inp, n):
    """The first n points of ``inp`` (the weights unchanged)."""
    return dict(inp, coords=inp["coords"][:n], cd_pe=inp["cd_pe"][:n], ref_t=inp["ref_t"][:, :n],
                g_p=inp["g_p"][:, :n], g_t=inp["g_t"][:, :, :n])


@functools.lru_cache(maxsize=None)
def _pallas_forward_300(dtype):
    """The Pallas forward kernel (interpret mode) on the 300 points of ``_inputs(300)``, once
    per dtype: each point's outputs depend on its own inputs only, so a case at n points reads
    the first n of them."""
    fw_j, pe_j, cd_j, ref_j = _jax_side(_inputs(300), dtype)
    p_k, t_k = jdk.fused_decode_jvp_v4s(fw_j, pe_j, cd_j, ref_j, block_n=BLOCK, interpret=True,
                                        compute_dtype=getattr(jnp, dtype))
    return np.asarray(p_k), np.asarray(t_k)


@functools.lru_cache(maxsize=None)
def _pallas_backward_300(dtype):
    """The Pallas backward kernel (interpret mode) on the 300 points of ``_inputs(300)``, traced
    and compiled once per dtype; called with cotangents that are zero past the first n points
    it gives the cotangents of those n points (every output is linear in the cotangents, point
    by point)."""
    fw_j, pe_j, cd_j, _ = _jax_side(_inputs(300), dtype)
    run = jax.jit(functools.partial(jdk.decode_bwd_kernel_v4s, block_n=BLOCK, interpret=True,
                                    compute_dtype=getattr(jnp, dtype)))
    return lambda g_p, g_t: run(fw_j, pe_j, cd_j, jnp.asarray(g_p), jnp.asarray(g_t))


# 1, 17, 64, 65, 129: the point-block edges of the port's tensor-core kernels (64 points a
# block), where chip_smoke.py holds them to these plain versions
EDGE_SIZES = [300, 3, 1, 17, 64, 65, 129]


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_kernel(dtype, n):
    inp = _first_points(_inputs(300), n)
    p_k, t_k = _pallas_forward_300(dtype)
    p_k, t_k = p_k[:, :n], t_k[:, :, :n]
    fw_t, pe_t, cd_t, ref_t = _port_side(inp, dtype)
    # the wrapper, which takes the plain version on CPU tensors
    before = tdk.fused_decode_jvp_v4s.launches
    p, t = tdk.fused_decode_jvp_v4s(fw_t, pe_t, cd_t, ref_t, getattr(torch, dtype))
    assert tdk.fused_decode_jvp_v4s.launches == before  # no kernel was launched
    assert tuple(p.shape) == (NV, n) and tuple(t.shape) == (3, NV, n) and p.dtype == torch.float32
    # same rounding points on both sides.  float32: summation order, the bar of
    # tests/test_decode_kernel_v4t.py.  bfloat16: the trig operands may differ
    # by one bf16 ulp between XLA and torch (see test_trig_cm_inputs_matches_jax),
    # and a summation-order difference can flip the rounding of p or of a tangent
    # (2^-9 relative of one of 32 terms), hence 2e-3 of the largest output
    tol = 2e-4 if dtype == "float32" else 2e-3
    for got, want in ((p, p_k), (t, t_k)):
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max())


def test_plain_forward_bf16_twin_rounding_differs_from_kernel_rounding():
    """``round_tangents`` selects between the kernel's and the XLA twin's rounding."""
    inp = _inputs(300)
    fw_j, pe_j, cd_j, ref_j = _jax_side(inp, "bfloat16")
    _, t_x = jdk.decode_jvp_xla_v4s(fw_j, pe_j, cd_j, ref_j, jnp.bfloat16)
    fw_t, pe_t, cd_t, ref_t = _port_side(inp, "bfloat16")
    _, t_twin = tdk.decode_jvp_v4s_ref(fw_t, pe_t, cd_t, ref_t, torch.bfloat16, round_tangents=False)
    _, t_kern = tdk.decode_jvp_v4s_ref(fw_t, pe_t, cd_t, ref_t, torch.bfloat16, round_tangents=True)
    scale = float(jnp.max(jnp.abs(t_x)))
    np.testing.assert_allclose(_np(t_twin), np.asarray(t_x), rtol=2e-3, atol=2e-3 * scale)
    assert float((t_twin - t_kern).abs().max()) > 0.0


# ---- the plain backward --------------------------------------------------------------

def _assert_cotangents_close(got, want, tol):
    """Per weight, relative to that weight's own largest cotangent."""
    for name in FIELDS:
        a, b = _np(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_kernel(dtype, n):
    full = _inputs(300)
    live = np.arange(300) < n
    want = _pallas_backward_300(dtype)(np.where(live, full["g_p"], 0.0).astype(np.float32),
                                       np.where(live, full["g_t"], 0.0).astype(np.float32))
    inp = _first_points(full, n)
    fw_t, pe_t, cd_t, _ = _port_side(inp, dtype)
    before = tdk.decode_bwd_kernel_v4s.launches
    got = tdk.decode_bwd_kernel_v4s(fw_t, pe_t, cd_t, _t(inp["g_p"]), _t(inp["g_t"]),
                                    getattr(torch, dtype))
    assert tdk.decode_bwd_kernel_v4s.launches == before
    # float32: the bar of tests/test_decode_kernel_v4s.py:133.  bfloat16: both
    # sides round every product operand at the same places; what is left is the
    # one-ulp trig difference and rounding flips of operands (2^-9 relative each)
    _assert_cotangents_close(got, want, 5e-4 if dtype == "float32" else 5e-3)


def test_plain_backward_matches_autograd_of_plain_forward():
    """float32: the hand-derived backward is the gradient of the plain forward."""
    inp = _inputs(300)
    fw, pe_cm, cd_pe, ref_t = _port_side(inp, "float32")
    g_p, g_t = _t(inp["g_p"]), _t(inp["g_t"])
    got = tdk.decode_bwd_v4s_ref(fw, pe_cm, cd_pe, g_p, g_t, torch.float32)
    leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
    p, t = tdk.decode_jvp_v4s_ref(leaves, pe_cm, cd_pe, torch.zeros_like(ref_t), torch.float32)
    ((p * g_p).sum() + (t * g_t).sum()).backward()
    want = tdk.FusedDecodeWeightsV6(*(w.grad for w in leaves))
    _assert_cotangents_close(got, want, 1e-4)


# ---- the autograd.Function -------------------------------------------------------------

def test_autograd_function_contract():
    """Exact weight cotangents, g_ref_t = g_primal_t, g_obias = sum, zeros for pe_cm / cd_pe."""
    inp = _inputs(300)
    fw, pe_cm, cd_pe, ref_t = _port_side(inp, "float32")

    def run(fn):
        leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
        points = [x.clone().requires_grad_(True) for x in (pe_cm, cd_pe, ref_t)]
        p, t = fn(leaves, *points)
        (torch.sin(p).sum() + (t * t).sum() * 1e8).backward()
        return p.detach(), t.detach(), leaves, points

    p_k, t_k, w_k, pts_k = run(lambda w, pe, cd, ref: tdk.fused_decode_jvp_v4s_kbwd(
        w, pe, cd, ref, torch.float32))
    p_x, t_x, w_x, pts_x = run(lambda w, pe, cd, ref: tdk.decode_jvp_v4s_ref(
        w, pe, cd, ref, torch.float32))
    np.testing.assert_array_equal(_np(p_k), _np(p_x))
    np.testing.assert_array_equal(_np(t_k), _np(t_x))
    _assert_cotangents_close(tdk.FusedDecodeWeightsV6(*(w.grad for w in w_k)),
                             tdk.FusedDecodeWeightsV6(*(w.grad for w in w_x)), 1e-4)
    # o = ... + ref_t: the identity head
    np.testing.assert_array_equal(_np(pts_k[2].grad), _np(torch.cos(p_k)))
    np.testing.assert_allclose(_np(w_k.obias.grad), _np(torch.cos(p_k).sum(1)), rtol=1e-6)
    # pe_cm and cd_pe are data in the training engine: zeros by contract, where
    # autograd of the plain version gives their true (non-zero) cotangents
    assert pts_k[0].grad.shape == pe_cm.shape and not pts_k[0].grad.any()
    assert pts_k[1].grad.shape == cd_pe.shape and not pts_k[1].grad.any()
    assert pts_x[0].grad.abs().max() > 0


def test_autograd_function_saves_no_activations():
    inp = _inputs(64)
    fw, pe_cm, cd_pe, ref_t = _port_side(inp, "float32")
    leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
    p, _ = tdk.fused_decode_jvp_v4s_kbwd(leaves, pe_cm, cd_pe, ref_t, torch.float32)
    saved = p.grad_fn.saved_tensors
    assert len(saved) == 2 + len(FIELDS)
    assert {tuple(s.shape) for s in saved} == (
        {tuple(pe_cm.shape), tuple(cd_pe.shape)} | {tuple(w.shape) for w in fw})


def test_wrappers_have_no_kernel_off_cpu_and_cuda():
    inp = _inputs(8)
    fw, pe_cm, cd_pe, ref_t = _port_side(inp, "float32")
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_decode_jvp_v4s(fw, pe_cm.to("meta"), cd_pe, ref_t, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.decode_bwd_kernel_v4s(fw, pe_cm.to("meta"), cd_pe, _t(inp["g_p"]), _t(inp["g_t"]),
                                  torch.float32)


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


# The point-block edges of the kernels (64 points a block), the size of a test above and the
# training step's larger launch
CARD_SIZES = (1, 17, 64, 65, 129, 1000, 20480)
# chip_smoke.py's rule for relu kinks: the points at which a relu argument of the plain version
# lies within KINK_EPS (1 + the largest argument) of zero, where another summation order may
# switch a tangent term on or off, are left out of the forward's comparison
KINK_EPS = 2e-6


def _near_kink(fw, pe, cd, dtype):
    n_vars, _, two_f, hid = fw.w1t.shape
    z = tdk.dot_f32(pe, fw.w1g.reshape(n_vars, 3 * two_f, hid), dtype) + fw.b1[:, None, :]
    near = (z.abs() < KINK_EPS * (1.0 + float(z.abs().max()))).any(-1).any(0)
    r = tdk.dot_f32(torch.relu(z), fw.w2f1, dtype) + tdk.dot_f32(cd, fw.wdf1, dtype) + fw.rbias[:, None, :]
    return near | (r.abs() < KINK_EPS * (1.0 + float(r.abs().max()))).any(-1).any(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v4s_kernels_match_plain(cuda_device, dtype):
    """The two CUDA kernels against their plain versions at the kernels' widths, at CARD_SIZES."""
    rng = np.random.RandomState(11)
    in_ch, hid, two_f = 192, 256, 64
    td = getattr(torch, dtype)

    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(cuda_device)

    fw = tdk.FusedDecodeWeightsV6(
        w1g=r(6, 3, two_f, hid), w1t=r(6, 3, two_f, hid, scale=1e-3), b1=r(6, hid),
        w2f1=r(6, hid, hid), wdf1=r(6, in_ch, hid), rbias=r(6, hid), fw2=r(6, hid),
        w2wo=r(6, hid), wdwo=r(6, in_ch), obias=r(6))
    n_max = max(CARD_SIZES)
    pe_all, cd_all, ref_all = r(n_max, in_ch, scale=1.0).to(td), r(n_max, in_ch, scale=1.0).to(td), r(6, n_max)
    gp_all, gt_all = r(6, n_max, scale=1.0), r(3, 6, n_max, scale=1.0)
    # the bounds of chip_smoke.py
    tol = 1e-5 if dtype == "float32" else 1e-3
    for n in CARD_SIZES:
        pe, cd, ref_t = pe_all[:n].contiguous(), cd_all[:n].contiguous(), ref_all[:, :n].contiguous()
        g_p, g_t = gp_all[:, :n].contiguous(), gt_all[:, :, :n].contiguous()
        before = tdk.fused_decode_jvp_v4s.launches, tdk.decode_bwd_kernel_v4s.launches
        p, t = tdk.fused_decode_jvp_v4s(fw, pe, cd, ref_t, td)
        g = tdk.decode_bwd_kernel_v4s(fw, pe, cd, g_p, g_t, td)
        torch.cuda.synchronize()
        assert (tdk.fused_decode_jvp_v4s.launches, tdk.decode_bwd_kernel_v4s.launches) == (
            before[0] + 1, before[1] + 1)
        p0, t0 = tdk.decode_jvp_v4s_ref(fw, pe, cd, ref_t, td)
        keep = ~_near_kink(fw, pe, cd, td)
        p, t, p0k, t0k = p[:, keep], t[:, :, keep], p0[:, keep], t0[:, :, keep]
        assert float((p - p0k).abs().max()) <= tol * (1.0 + float(p0.abs().max())), n
        for k in range(3):
            assert float((t[k] - t0k[k]).abs().max()) <= tol * float(t0[k].abs().max()), (n, k)
        _assert_cotangents_close(g, tdk.decode_bwd_v4s_ref(fw, pe, cd, g_p, g_t, td),
                                 1e-4 if dtype == "float32" else 2e-3)
