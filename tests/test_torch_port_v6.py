"""PyTorch port against the JAX package: the v6 decode pair of ``kernel_version=6``.

The same numpy inputs, made from a seed, go through the JAX functions of
``deepphysinet_tpu/ops/decode_kernel.py`` and their counterparts in
``deepphysinet_tpu_torch/ops/decode_kernel.py``.  The Pallas kernels run as the
JAX package's own tests run them on the CPU (``tests/test_decode_kernel_v6.py``),
in interpret mode.  On the CPU the port's wrappers take their plain versions,
which is what these tests hold to JAX; the CUDA kernels are held to the same
plain versions on the card (the test marked ``cuda`` here, and ``chip_smoke.py``).

Which JAX function each plain version is held to:

* float32: the plain forward against the XLA twin ``decode_jvp_xla_v6`` at rtol
  1e-5 (no rounding anywhere, so twin and kernel are the same function) and
  against the Pallas kernel (primal 2e-5, tangents 2e-4 of the largest, the
  bars of the JAX tests); the plain backward against the Pallas backward kernel
  per weight at 2e-4 of that weight's largest cotangent;
* bfloat16: the Pallas kernels.  The forward kernel stores the masked tangents
  in bf16 and its XLA twin does not; the port's plain forward copies the
  kernel's rounding, and with ``round_tangents=False`` the twin's.  The backward
  kernel reads the recomputed tangents unrounded in its ``fw2`` and ``w2wo``
  sums, so in bf16 it differentiates another forward than the forward kernel
  computes; the plain backward follows it, and a test pins the difference.
"""

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
BLOCK = 32
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
    return dict(w=w, coords=coords, cd_pe=r(n, IN_CH), ref=r(n, NV),
                g_p=r(n, NV, scale=1.0), g_t=r(3, n, NV, scale=1.0))


def _jax_side(inp):
    """``fuse_decode_weights_v6`` and ``trig3_inputs`` (float32: the wrappers cast)."""
    spec = JaxCoordSpec(**SPEC)
    fw6 = jdk.fuse_decode_weights_v6(
        jdk.DecodeWeights(**{k: jnp.asarray(v) for k, v in inp["w"].items()}), spec)
    return fw6, jdk.trig3_inputs(jnp.asarray(inp["coords"]), spec), jnp.asarray(inp["cd_pe"]), jnp.asarray(inp["ref"])


def _port_side(inp, dtype="float32"):
    spec = CoordSpec(**SPEC)
    fw6 = tdk.fuse_decode_weights_v6(tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()}), spec)
    td = getattr(torch, dtype)
    return fw6, tdk.trig3_inputs(_t(inp["coords"]), spec, td), _t(inp["cd_pe"]).to(td), _t(inp["ref"])


# ---- prep: trig blocks and weight folding ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trig3_inputs_matches_jax(dtype):
    inp = _inputs(300)
    want = jdk.trig3_inputs(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC)).astype(getattr(jnp, dtype))
    got = tdk.trig3_inputs(_t(inp["coords"]), CoordSpec(**SPEC), getattr(torch, dtype))
    assert tuple(got.shape) == (3, 300, TWO_F) and got.dtype == getattr(torch, dtype)
    # sin/cos of arguments up to 16: a few float32 ulp; one bf16 ulp (2^-8) where
    # such a difference crosses a rounding boundary
    atol = 2e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=0, atol=atol)
    # the blocks of the v4s operand, laid out by direction
    cm = tdk.trig_cm_inputs(_t(inp["coords"]), CoordSpec(**SPEC), getattr(torch, dtype))
    np.testing.assert_array_equal(_np(got.permute(1, 0, 2).reshape(300, IN_CH)), _np(cm))


def test_fuse_decode_weights_v6_matches_jax():
    inp = _inputs(4)
    want, got = _jax_side(inp)[0], _port_side(inp)[0]
    for name in FIELDS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6 * max(np.abs(b).max(), 1e-30), err_msg=name)


# ---- the plain forward -----------------------------------------------------------

@pytest.mark.parametrize("round_tangents", [True, False])
def test_plain_forward_matches_xla_twin_f32(round_tangents):
    inp = _inputs(96)
    p_x, t_x = jdk.decode_jvp_xla_v6(*_jax_side(inp), jnp.float32)
    p, t = tdk.decode_jvp_v6_ref(*_port_side(inp), torch.float32, round_tangents)
    assert tuple(p.shape) == (96, NV) and tuple(t.shape) == (3, 96, NV)
    # tangents carry the folded scales 1 / (dx (lon - 1)): absolute floor at their magnitude
    np.testing.assert_allclose(_np(p), np.asarray(p_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t), np.asarray(t_x), rtol=1e-5, atol=1e-5 * float(jnp.max(jnp.abs(t_x))))


@pytest.mark.parametrize("n", [96, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_kernel(dtype, n):
    """n = 50 is ragged against the Pallas block of 32."""
    inp = _inputs(n)
    p_k, t_k = jdk.fused_decode_jvp_v6(*_jax_side(inp), block_n=BLOCK, interpret=True,
                                       compute_dtype=getattr(jnp, dtype))
    fw, trig, cd_pe, ref = _port_side(inp)  # float32 in: the wrapper casts, as the JAX wrapper does
    before = tdk.fused_decode_jvp_v6.launches
    p, t = tdk.fused_decode_jvp_v6(fw, trig, cd_pe, ref, getattr(torch, dtype))
    assert tdk.fused_decode_jvp_v6.launches == before  # no kernel was launched
    assert tuple(p.shape) == (n, NV) and tuple(t.shape) == (3, n, NV) and p.dtype == torch.float32
    # same rounding points on both sides.  float32: summation order (the TPU kernel
    # sums z as three K = 2F products), at the bars of tests/test_decode_kernel_v6.py.
    # bfloat16: the trig operands may differ by one bf16 ulp between XLA and torch, and
    # a summation-order difference can flip the rounding of p or of a tangent (2^-9
    # relative of one of 32 terms), hence 2e-3 of the largest output
    tol_p, tol_t = (2e-5, 2e-4) if dtype == "float32" else (2e-3, 2e-3)
    np.testing.assert_allclose(_np(p), np.asarray(p_k), rtol=tol_p, atol=tol_p * np.abs(np.asarray(p_k)).max())
    np.testing.assert_allclose(_np(t), np.asarray(t_k), rtol=tol_t, atol=tol_t * np.abs(np.asarray(t_k)).max())


def test_plain_forward_bf16_twin_rounding_differs_from_kernel_rounding():
    """``round_tangents`` selects between the kernel's and the XLA twin's rounding; the twin
    besides reads the float32 cd PE in its ``wdwo`` sum where the kernel reads bf16."""
    inp = _inputs(96)
    fw_j, trig_j, cd_j, ref_j = _jax_side(inp)
    p_x, t_x = jdk.decode_jvp_xla_v6(fw_j, trig_j, cd_j, ref_j, jnp.bfloat16)
    fw, trig, cd_pe, ref = _port_side(inp)
    bf = torch.bfloat16
    p_twin, t_twin = tdk.decode_jvp_v6_ref(fw, trig, cd_pe, ref, bf, round_tangents=False)
    p_kern, t_kern = tdk.decode_jvp_v6_ref(fw, trig.to(bf), cd_pe.to(bf), ref, bf, round_tangents=True)
    np.testing.assert_allclose(_np(t_twin), np.asarray(t_x), rtol=2e-3, atol=2e-3 * float(jnp.max(jnp.abs(t_x))))
    np.testing.assert_allclose(_np(p_twin), np.asarray(p_x), rtol=2e-3, atol=2e-3 * float(jnp.max(jnp.abs(p_x))))
    assert float((t_twin - t_kern).abs().max()) > 0.0
    assert float((p_twin - p_kern).abs().max()) > 0.0  # the cd PE's rounding in the wdwo sum


def test_v6_is_the_v4s_function_in_another_layout():
    """Same fold, same weights: the v6 outputs are the v4s outputs transposed."""
    inp = _inputs(96)
    fw, trig, cd_pe, ref = _port_side(inp)
    pe_cm = tdk.trig_cm_inputs(_t(inp["coords"]), CoordSpec(**SPEC))
    for dtype in (torch.float32, torch.bfloat16):
        p6, t6 = tdk.decode_jvp_v6_ref(fw, trig.to(dtype), cd_pe.to(dtype), ref, dtype)
        ps, ts = tdk.decode_jvp_v4s_ref(fw, pe_cm.to(dtype), cd_pe.to(dtype), ref.t(), dtype)
        np.testing.assert_array_equal(_np(p6), _np(ps.t()))
        np.testing.assert_array_equal(_np(t6), _np(ts.transpose(1, 2)))


# ---- the plain backward --------------------------------------------------------------

def _assert_cotangents_close(got, want, tol):
    """Per weight, relative to that weight's own largest cotangent."""
    for name in FIELDS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("n", [96, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_kernel(dtype, n):
    inp = _inputs(n)
    fw_j, trig_j, cd_j, _ = _jax_side(inp)
    want = jdk.decode_bwd_kernel_v6(fw_j, trig_j, cd_j, jnp.asarray(inp["g_p"]), jnp.asarray(inp["g_t"]),
                                    block_n=BLOCK, interpret=True, compute_dtype=getattr(jnp, dtype))
    fw, trig, cd_pe, _ = _port_side(inp)
    before = tdk.decode_bwd_kernel_v6.launches
    got = tdk.decode_bwd_kernel_v6(fw, trig, cd_pe, _t(inp["g_p"]), _t(inp["g_t"]), getattr(torch, dtype))
    assert tdk.decode_bwd_kernel_v6.launches == before
    # float32: 2e-4 of each weight's largest cotangent (summation order over the
    # points and the TPU kernel's block-wise accumulation).  bfloat16: both sides
    # round every product operand at the same places; what is left is the one-ulp
    # trig difference and rounding flips of operands (2^-9 relative each)
    _assert_cotangents_close(got, want, 2e-4 if dtype == "float32" else 5e-3)


def test_plain_backward_matches_autograd_of_plain_forward():
    """float32: the hand-derived backward is the gradient of the plain forward."""
    inp = _inputs(96)
    fw, trig, cd_pe, ref = _port_side(inp)
    g_p, g_t = _t(inp["g_p"]), _t(inp["g_t"])
    got = tdk.decode_bwd_v6_ref(fw, trig, cd_pe, g_p, g_t, torch.float32)
    leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
    p, t = tdk.decode_jvp_v6_ref(leaves, trig, cd_pe, torch.zeros_like(ref), torch.float32)
    ((p * g_p).sum() + (t * g_t).sum()).backward()
    _assert_cotangents_close(got, tdk.FusedDecodeWeightsV6(*(w.grad for w in leaves)), 1e-4)


def test_backward_bf16_keeps_the_recomputed_tangents_unrounded():
    """The backward kernel's ``w2wo`` cotangent is ``2 (sum p go + sum t gto)`` over the
    UNROUNDED masked tangents (:2164, :2182), where the forward kernel's ``w2wo`` sum
    reads them rounded to bf16: the plain backward follows the backward kernel."""
    inp = _inputs(96)
    bf = torch.bfloat16
    fw, trig, cd_pe, _ = _port_side(inp, "bfloat16")
    g_p, g_t = torch.zeros(96, NV), _t(inp["g_t"])  # the tangent terms alone
    got = tdk.decode_bwd_v6_ref(fw, trig, cd_pe, g_p, g_t, bf).w2wo
    n_vars = fw.w1g.shape[0]
    z = tdk.dot_f32(torch.cat(list(trig), -1), fw.w1g.reshape(n_vars, IN_CH, HID), bf) + fw.b1[:, None, :]
    t = torch.stack([torch.where(z > 0, tdk.dot_f32(trig[k], fw.w1t[:, k], bf), 0.0) for k in range(3)])
    gto = g_t.permute(0, 2, 1)[..., None]  # [3, V, N, 1]
    unrounded = 2.0 * (t * gto).sum((0, 2))
    rounded = 2.0 * (t.to(bf).float() * gto).sum((0, 2))
    np.testing.assert_allclose(_np(got), _np(unrounded), rtol=1e-5, atol=1e-5 * float(unrounded.abs().max()))
    assert float((rounded - unrounded).abs().max()) > 1e-4 * float(unrounded.abs().max())
    # and autograd of the plain forward with the kernel's rounding gives the rounded form
    leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
    _, tang = tdk.decode_jvp_v6_ref(leaves, trig, cd_pe, torch.zeros(96, NV), bf)
    (tang * g_t).sum().backward()
    assert float((leaves.w2wo.grad - got).abs().max()) > 0.0


# ---- the autograd.Function -------------------------------------------------------------

def test_autograd_function_contract():
    """Exact weight cotangents, g_ref = g_primal, g_obias = sum, zeros for trig / cd_pe."""
    inp = _inputs(96)
    fw, trig, cd_pe, ref = _port_side(inp)

    def run(fn):
        leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
        points = [x.clone().requires_grad_(True) for x in (trig, cd_pe, ref)]
        p, t = fn(leaves, *points)
        (torch.sin(p).sum() + (t * t).sum() * 1e8).backward()
        return p.detach(), t.detach(), leaves, points

    p_k, t_k, w_k, pts_k = run(lambda w, *pts: tdk.fused_decode_jvp_v6_kbwd(w, *pts, torch.float32))
    p_x, t_x, w_x, pts_x = run(lambda w, *pts: tdk.decode_jvp_v6_ref(w, *pts, torch.float32))
    np.testing.assert_array_equal(_np(p_k), _np(p_x))
    np.testing.assert_array_equal(_np(t_k), _np(t_x))
    _assert_cotangents_close(tdk.FusedDecodeWeightsV6(*(w.grad for w in w_k)),
                             tdk.FusedDecodeWeightsV6(*(w.grad for w in w_x)), 1e-4)
    # o = ... + ref: the identity head
    np.testing.assert_array_equal(_np(pts_k[2].grad), _np(torch.cos(p_k)))
    np.testing.assert_allclose(_np(w_k.obias.grad), _np(torch.cos(p_k).sum(0)), rtol=1e-6)
    # trig and cd_pe are data in the training engine: zeros by contract, where
    # autograd of the plain version gives their true (non-zero) cotangents
    assert pts_k[0].grad.shape == trig.shape and not pts_k[0].grad.any()
    assert pts_k[1].grad.shape == cd_pe.shape and not pts_k[1].grad.any()
    assert pts_x[0].grad.abs().max() > 0
    # inputs that need no gradient get none, and no activations are saved
    leaves = tdk.FusedDecodeWeightsV6(*(w.clone().requires_grad_(True) for w in fw))
    p, _ = tdk.fused_decode_jvp_v6_kbwd(leaves, trig, cd_pe, ref, torch.float32)
    saved = p.grad_fn.saved_tensors
    assert len(saved) == 2 + len(FIELDS)
    assert {tuple(s.shape) for s in saved} == ({tuple(trig.shape), tuple(cd_pe.shape)} | {tuple(w.shape) for w in fw})
    p.sum().backward()
    assert trig.grad is None and cd_pe.grad is None and ref.grad is None


def test_wrappers_have_no_kernel_off_cpu_and_cuda_and_check_the_operand():
    inp = _inputs(8)
    fw, trig, cd_pe, ref = _port_side(inp)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_decode_jvp_v6(fw, trig.to("meta"), cd_pe, ref, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.decode_bwd_kernel_v6(fw, trig.to("meta"), cd_pe, _t(inp["g_p"]), _t(inp["g_t"]), torch.float32)
    with pytest.raises(ValueError, match=r"expected \[3, N, 2F\]"):
        tdk.fused_decode_jvp_v6(fw, trig.permute(1, 0, 2), cd_pe, ref, torch.float32)


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v6_kernels_match_plain(cuda_device, dtype):
    """The two CUDA kernels against their plain versions at the kernels' widths."""
    rng = np.random.RandomState(11)
    n, in_ch, hid, two_f = 1000, 192, 256, 64
    td = getattr(torch, dtype)

    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(cuda_device)

    fw = tdk.FusedDecodeWeightsV6(
        w1g=r(6, 3, two_f, hid), w1t=r(6, 3, two_f, hid, scale=1e-3), b1=r(6, hid),
        w2f1=r(6, hid, hid), wdf1=r(6, in_ch, hid), rbias=r(6, hid), fw2=r(6, hid),
        w2wo=r(6, hid), wdwo=r(6, in_ch), obias=r(6))
    trig, cd, ref = r(3, n, two_f, scale=1.0).to(td), r(n, in_ch, scale=1.0).to(td), r(n, 6)
    g_p, g_t = r(n, 6, scale=1.0), r(3, n, 6, scale=1.0)
    before = tdk.fused_decode_jvp_v6.launches, tdk.decode_bwd_kernel_v6.launches
    p, t = tdk.fused_decode_jvp_v6(fw, trig, cd, ref, td)
    g = tdk.decode_bwd_kernel_v6(fw, trig, cd, g_p, g_t, td)
    torch.cuda.synchronize()
    assert (tdk.fused_decode_jvp_v6.launches, tdk.decode_bwd_kernel_v6.launches) == (before[0] + 1, before[1] + 1)
    p0, t0 = tdk.decode_jvp_v6_ref(fw, trig, cd, ref, td)
    # the bounds of chip_smoke.py
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert float((p - p0).abs().max()) <= tol * (1.0 + float(p0.abs().max()))
    assert float((t - t0).abs().max()) <= tol * float(t0.abs().max())
    _assert_cotangents_close(g, tdk.decode_bwd_v6_ref(fw, trig, cd, g_p, g_t, td),
                             1e-4 if dtype == "float32" else 2e-3)
