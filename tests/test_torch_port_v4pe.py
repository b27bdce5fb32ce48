"""PyTorch port against the JAX package: the collapsed v4 decode with the PE computed in the
kernel (v4pe, the ``in_kernel_pe`` route of ``fused_kernel_fields``) and with ``r`` summed
in another order (v5).

The same numpy inputs, made from a seed, go through the JAX functions of
``deepphysinet_tpu/ops/decode_kernel.py`` and their counterparts in
``deepphysinet_tpu_torch/ops/decode_kernel.py``.  The Pallas kernels run in interpret mode,
as the JAX package's own tests run them on the CPU; the port's wrappers take their plain
versions on CPU tensors.  The CUDA kernels (compile-time variants of
``csrc/decode_jvp_v4.cu``) are held to the same plain versions on the card (the test
marked ``cuda`` here, and ``chip_smoke.py``).

Bars, the JAX tests' own (``tests/test_decode_kernel.py:93-97``): primal rtol 2e-4 and
atol 2e-5; tangents rtol 2e-3 with an absolute floor of 2e-3 of the largest tangent.  Both
sides round at the same places (v4pe: the in-kernel PE, its tangents and the cd PE each
rounded to the compute dtype; v5: the masked tangents rounded once), so what is left is
float32 summation order and, in bfloat16, a flipped rounding of an operand.
"""

import functools

import numpy as np
import pytest
import torch

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

from tests.test_torch_port_engine import _j_args, _t_args, world  # noqa: F401
from tests.test_torch_port_v2 import V2_POINTS, NV, _amax, _assert_outputs_close, _first_points, _inputs, _np, _t

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

F = 8
IN_CH = 6 * F
BLOCK = 32
SPEC = dict(lon_size=17, lat_size=9, dx=27000.0, dy=27000.0, pred_t_span=86400.0, n_freqs=F)


def _fused(inp):
    """The fused weights of both packages (float32)."""
    jw = jdk.DecodeWeights(**{k: jnp.asarray(v) for k, v in inp["w"].items()})
    tw = tdk.DecodeWeights(**{k: _t(v) for k, v in inp["w"].items()})
    return jdk.fuse_decode_weights(jw), tdk.fuse_decode_weights(tw)


def _v4_inputs(inp, dtype="float32"):
    """The v4 point inputs of both packages: JAX's float32 (the wrappers cast), the port's in
    ``dtype``, as its engine hands them on."""
    jpe, jdpe = jdk.pe_and_tangents(jnp.asarray(inp["coords"]), JaxCoordSpec(**SPEC))
    jcd = j_sinecos_pe(jnp.asarray(inp["cdata"]), j_bands(IN_CH // 12, 4.0), include_input=False)
    td = getattr(torch, dtype)
    tpe, tdpe = tdk.pe_and_tangents(_t(inp["coords"]), CoordSpec(**SPEC), td)
    tcd = sinecos_pe(_t(inp["cdata"]), make_freq_bands(IN_CH // 12, 4.0)).to(td)
    return (jpe, jdpe, jcd, jnp.asarray(inp["ref"])), (tpe, tdpe, tcd, _t(inp["ref"]))


# ---- v4pe ---------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pallas_v4pe_forward(dtype):
    """The v4pe Pallas kernel (interpret mode) on the V2_POINTS points of ``_inputs(V2_POINTS, seed=5)``,
    once per dtype: each point's outputs depend on its own inputs only, so a case at n points reads
    the first n of them."""
    inp = _inputs(V2_POINTS, seed=5)
    p_k, t_k = jdk.fused_decode_jvp_v4pe(_fused(inp)[0], jnp.asarray(inp["coords"]), jnp.asarray(inp["cdata"]),
                                         JaxCoordSpec(**SPEC), block_n=BLOCK, interpret=True,
                                         compute_dtype=getattr(jnp, dtype))
    return np.asarray(p_k), np.asarray(t_k)


# n = 50 is ragged against the Pallas block of 32; 1, 17, 64, 65 and 129 are the point-block edges of
# the port's tensor-core kernel (64 points a block)
@pytest.mark.parametrize("n", [64, 50, 1, 17, 65, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v4pe_plain_forward_matches_pallas_kernel(dtype, n):
    p_k, t_k = _pallas_v4pe_forward(dtype)
    p_k, t_k = p_k[:n], t_k[:, :n]
    inp = _first_points(_inputs(V2_POINTS, seed=5), n)
    _, tfw = _fused(inp)
    before = tdk.fused_decode_jvp_v4pe.launches
    p, t = tdk.fused_decode_jvp_v4pe(tfw, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC),
                                     getattr(torch, dtype))
    assert tdk.fused_decode_jvp_v4pe.launches == before  # no kernel was launched
    assert tuple(p.shape) == (n, NV) and tuple(t.shape) == (3, n, NV) and p.dtype == torch.float32
    _assert_outputs_close(p, t, p_k, t_k)


def test_v4pe_is_v4_behind_the_front_end():
    """float32: v4pe on raw values is v4 on the prepared PE, the conditioning values as
    reference values, up to the order of the features in each sum."""
    inp = _inputs(64, seed=5)
    _, tfw = _fused(inp)
    _, (pe, dpe, cd_pe, _) = _v4_inputs(inp)
    p, t = tdk.decode_jvp_v4pe_ref(tfw, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC), torch.float32)
    p4, t4 = tdk.decode_jvp_v4_ref(tfw, pe, dpe, cd_pe, _t(inp["cdata"]), torch.float32)
    _assert_outputs_close(p, t, _np(p4), _np(t4))


def test_v4pe_checks_the_frequencies_and_the_device():
    inp = _inputs(8, seed=5)
    jfw, tfw = _fused(inp)
    other = dict(SPEC, n_freqs=F + 1)
    with pytest.raises(ValueError, match="implies 8 coord freqs"):  # JAX's check (:1337-1340)
        jdk.fused_decode_jvp_v4pe(jfw, jnp.asarray(inp["coords"]), jnp.asarray(inp["cdata"]),
                                  JaxCoordSpec(**other), interpret=True)
    with pytest.raises(ValueError, match="implies 8 coordinate frequencies"):
        tdk.fused_decode_jvp_v4pe(tfw, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**other))
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_decode_jvp_v4pe(tfw, _t(inp["coords"]).to("meta"), _t(inp["cdata"]), CoordSpec(**SPEC))
    five = tdk.FusedDecodeWeights(*(x[:5] for x in tfw))  # the conditioning values are 6 reference values
    with pytest.raises(ValueError, match="got 5 variables"):
        tdk.fused_decode_jvp_v4pe(five, _t(inp["coords"]), _t(inp["cdata"]), CoordSpec(**SPEC))


# ---- v5 -----------------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v5_plain_forward_matches_pallas_kernel(dtype, n):
    inp = _inputs(n, seed=6)
    jfw, tfw = _fused(inp)
    jins, tins = _v4_inputs(inp, dtype)
    p_k, t_k = jdk.fused_decode_jvp_v5(jfw, *jins, block_n=BLOCK, interpret=True,
                                       compute_dtype=getattr(jnp, dtype))
    before = tdk.fused_decode_jvp_v5.launches
    p, t = tdk.fused_decode_jvp_v5(tfw, *tins, getattr(torch, dtype))
    assert tdk.fused_decode_jvp_v5.launches == before
    assert tuple(p.shape) == (n, NV) and tuple(t.shape) == (3, n, NV)
    _assert_outputs_close(p, t, p_k, t_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v5_is_v4_with_one_sum_in_another_order(dtype):
    """The v5 plain version against the v4 one on the same inputs: the same function (within
    float32 rounding of ``r``'s three terms, and in bfloat16 a rounding of p or a tangent
    that flips with them), and not the same arithmetic: the sum ``r`` is taken in another
    order (``_decode_kernel_v5`` :1149, :1156 against ``_v4_epilogue`` :548)."""
    inp = _inputs(64, seed=6)
    _, tfw = _fused(inp)
    _, tins = _v4_inputs(inp, dtype)
    td = getattr(torch, dtype)
    p5, t5 = tdk.decode_jvp_v5_ref(tfw, *tins, td)
    p4, t4 = tdk.decode_jvp_v4_ref(tfw, *tins, td)
    _assert_outputs_close(p5, t5, _np(p4), _np(t4))
    l1 = tdk._layer1_v4(tfw, tins[0], tins[1])
    z = tdk.dot_f32(l1.pe, l1.w1, td) + tfw.b1[:, None, :]
    a, b = tdk.dot_f32(torch.relu(z), tfw.w2f1, td), tdk.dot_f32(tins[2], tfw.wdf1, td)
    rb = tfw.rbias[:, None, :]
    assert not torch.equal(a + (b + rb), (a + b) + rb)


# ---- the engine's in_kernel_pe route --------------------------------------------------------

@pytest.mark.parametrize("version", [4, 7])
def test_fused_kernel_fields_in_kernel_pe_matches_jax(world, version):  # noqa: F811
    """``in_kernel_pe=True`` with version 4 or 7 and not trainable takes v4pe in both packages
    (:449-461); float32, the engine's 96 points of one window."""
    p_j, t_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"], interpret=True,
                                           version=version, in_kernel_pe=True, raw_tangents=True)
    calls = []
    v4pe = tengine.fused_decode_jvp_v4pe
    tengine.fused_decode_jvp_v4pe = lambda *a: calls.append(1) or v4pe(*a)
    try:
        p_t, t_t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                               version=version, in_kernel_pe=True, raw_tangents=True)
        _, fd_t = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"],
                                              version=version, in_kernel_pe=True)
    finally:
        tengine.fused_decode_jvp_v4pe = v4pe
    assert calls == [1, 1]
    _assert_outputs_close(p_t, t_t, p_j, t_j)
    # the assembled fields are the raw tangents' chain rule, as on the other routes
    _, fd_j = jengine.fused_kernel_fields(*_j_args(world), world["jspec"], world["jspecs"], interpret=True,
                                          version=version, in_kernel_pe=True)
    for k in tengine.FIELD_KEYS:
        np.testing.assert_allclose(fd_t.fields[k].detach().numpy(), np.asarray(fd_j.fields[k]),
                                   rtol=2e-4, atol=2e-4 * np.abs(np.asarray(fd_j.fields[k])).max())


def test_in_kernel_pe_takes_v4pe_only_where_jax_does(world, monkeypatch):  # noqa: F811
    """``trainable`` and versions other than 4 and 7 ignore ``in_kernel_pe``, as in JAX: the
    results are those of the same call without it, to the bit."""
    calls = []
    monkeypatch.setattr(tengine, "fused_decode_jvp_v4pe", lambda *a: calls.append(1))
    for version, trainable in ((4, True), (7, True), (6, False), (2, False), (2, True)):
        kw = dict(version=version, trainable=trainable, raw_tangents=True)
        with_pe = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"], in_kernel_pe=True, **kw)
        without = tengine.fused_kernel_fields(*_t_args(world), world["tspec"], world["tspecs"], **kw)
        for a, b in zip(with_pe, without):
            assert torch.equal(a, b), (version, trainable)
    assert calls == []


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v4pe_and_v5_kernels_match_plain(cuda_device, dtype):
    """The two CUDA variants against their plain versions at the kernels' widths and the sizes
    of ``CARD_SIZES``, with the bounds of chip_smoke.py and its rule for the points near a relu
    kink (each variant's own operands: v4pe's channel-major PE in float32); two runs of each
    kernel give the same bits, and each kernel's rows at a smaller size the first rows of its
    largest call; and the v4 kernel, which shares their source (bf16: the same tensor-core body,
    v5 with r's split sum), still the v4 function.  In bfloat16 also the rows of the kernels' PE front ends, bit for bit: the
    tensor-core bodies' (one sincosf an angle) against the CUDA-core bodies' (sinf, cosf), and
    their recompute's against their front end's."""
    from tests.test_torch_port_v2 import CARD_SIZES, _card_weights
    from tests.test_torch_port_v4 import _near_kink

    rng = np.random.RandomState(13)
    n_max, td = max(CARD_SIZES), getattr(torch, dtype)
    fw = tdk.fuse_decode_weights(_card_weights(cuda_device, rng))
    fw_cm = tdk._channel_major(fw)
    spec = CoordSpec(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
    coords_all = torch.from_numpy(np.stack([rng.rand(n_max) * 27000 * 256, rng.rand(n_max) * 27000 * 144,
                                            rng.rand(n_max) * 86400.0], -1).astype(np.float32)).to(cuda_device)
    cdata_all = torch.from_numpy((rng.randn(n_max, 6) * 0.3).astype(np.float32)).to(cuda_device)
    tol = 1e-5 if dtype == "float32" else 1e-3
    firsts = {}  # (kernel, n) -> its outputs: each point's result hangs on no other point
    for n in CARD_SIZES:
        coords, cdata = coords_all[:n].contiguous(), cdata_all[:n].contiguous()
        pe, dpe = tdk.pe_and_tangents(coords, spec, td)
        cd_pe = sinecos_pe(cdata, make_freq_bands(16, 4.0)).to(td)
        before = tdk.fused_decode_jvp_v4pe.launches, tdk.fused_decode_jvp_v5.launches
        runs = [{"v4pe": tdk.fused_decode_jvp_v4pe(fw, coords, cdata, spec, td),
                 "v5": tdk.fused_decode_jvp_v5(fw, pe, dpe, cd_pe, cdata, td),
                 "v4": tdk.fused_decode_jvp_v4(fw, pe, dpe, cd_pe, cdata, td)} for _ in range(2)]
        torch.cuda.synchronize()
        assert (tdk.fused_decode_jvp_v4pe.launches, tdk.fused_decode_jvp_v5.launches) == (before[0] + 2,
                                                                                         before[1] + 2)
        plain = {"v4pe": tdk.decode_jvp_v4pe_ref(fw, coords, cdata, spec, td),
                 "v5": tdk.decode_jvp_v5_ref(fw, pe, dpe, cd_pe, cdata, td),
                 "v4": tdk.decode_jvp_v4_ref(fw, pe, dpe, cd_pe, cdata, td)}
        pe_cm, _, cd_cm = tdk.pe_front_end(coords, cdata, spec, 192)
        near_cm, near = _near_kink(fw_cm, pe_cm.to(td), cd_cm.to(td), td), _near_kink(fw, pe, cd_pe, td)
        for k, (p, t) in runs[0].items():
            assert torch.equal(p, runs[1][k][0]) and torch.equal(t, runs[1][k][1]), (k, n)
            firsts[(k, n)] = (p, t)
            p0, t0 = plain[k]
            keep = ~(near_cm if k == "v4pe" else near)
            p, t, p0, t0 = p[keep], t[:, keep], p0[keep], t0[:, keep]
            assert _amax(p - p0) <= tol * (1.0 + _amax(p0)), (k, n)
            for d in range(3):
                assert _amax(t[d] - t0[d]) <= 10 * tol * _amax(t0[d]), (k, n)
        if dtype == "bfloat16":
            rows = {f: tdk.pe_front_end_rows(coords, cdata, spec, 192, f) for f in tdk.PE_FRONT_ENDS}
            torch.cuda.synchronize()
            for a, b in zip(rows["tensor_cores"], rows["cuda_cores"]):
                assert torch.equal(a, b), n
            for a, b in zip(rows["recompute"][:2], rows["tensor_cores"][:2]):
                assert torch.equal(a, b), n
    # at the block edges (1, 17, 64, 65, 129) the kink rule may leave no point to compare: each
    # kernel's rows at a smaller size are the first n rows of its largest call, bit for bit
    for (k, n), (p, t) in firsts.items():
        p1, t1 = firsts[(k, n_max)]
        assert torch.equal(p, p1[:n]) and torch.equal(t, t1[:, :n]), (k, n)
