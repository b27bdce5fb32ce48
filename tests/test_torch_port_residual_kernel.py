"""PyTorch port against the JAX package: the in-kernel residual assembly.

The same model weights (JAX init, carried over) and the same numpy points go
through ``deepphysinet_tpu/ops/residual_kernel.py`` -- its two Pallas kernels in
interpret mode, as ``tests/test_residual_kernel.py`` runs them on the CPU -- and
through ``deepphysinet_tpu_torch/ops/residual_kernel.py``, whose wrappers take
their plain versions on CPU tensors.  The CUDA kernel is held to the same plain
versions on the card (``chip_smoke.py``, and the test marked ``cuda`` here).

Tolerance: every loss relative to itself at 1e-4 in float32, the bar of
``tests/test_residual_kernel.py:70`` (sums of squares of differences of large
terms over at most 96 points, decode chains in another summation order), and at
2e-2 in bfloat16 (a bf16 rounding of a tangent is 2^-9 relative, and the
residuals square it).  The port's in-kernel path against the port's own split
path: 1e-5 in float32, the same decode and the same equations, summed in another
order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.ops import decode_kernel as jdk
from deepphysinet_tpu.ops import residual_kernel as jrk
from deepphysinet_tpu.ops.position_encoding import make_freq_bands as j_bands
from deepphysinet_tpu.ops.position_encoding import sinecos_pe as j_sinecos_pe
from deepphysinet_tpu.physics import engine as jengine

from deepphysinet_tpu_torch.ops import decode_kernel as tdk
from deepphysinet_tpu_torch.ops import residual_kernel as trk
from deepphysinet_tpu_torch.ops.position_encoding import make_freq_bands, sinecos_pe
from deepphysinet_tpu_torch.physics import engine as tengine

from tests.test_torch_port_engine import FACTORS, _j_args, _t, _t_args, world  # noqa: F401

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

BLOCK = 32
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _points(world, n):  # noqa: F811
    """The first n of the world's 96 points, as both packages' argument tuples."""
    w = dict(world, coords=world["coords"][:n], nwp=world["nwp"][:n])
    return w, _j_args(w), _t_args(w), world["f"][:n]


def _decode_inputs(world, n, version):  # noqa: F811
    """Fused weights and point operands of both packages, float32 (the wrappers cast)."""
    w, (jmodel, params, jtokens, jcoords, jnwp, jfh), (tmodel, ttokens, tcoords, tnwp, tfh), f = _points(world, n)
    jfw = jdk.fuse_decode_weights(jdk.extract_decode_weights(jmodel, params, jtokens, jfh))
    jcd = j_sinecos_pe(jnwp, j_bands(192 // 2 // 6, max_freq=4.0), include_input=False)
    with torch.no_grad():
        tfw = tdk.fuse_decode_weights(tdk.extract_decode_weights(tmodel, ttokens, tfh))
    tcd = sinecos_pe(tnwp, make_freq_bands(192 // 2 // 6, max_freq=4.0), include_input=False)
    if version == 6:
        jins = (jdk.fuse_v6_from_v4(jfw, w["jspec"]), jdk.trig3_inputs(jcoords, w["jspec"]), jcd, jnwp)
        tins = (tdk.fuse_v6_from_v4(tfw, w["tspec"]), tdk.trig3_inputs(tcoords, w["tspec"]), tcd, tnwp)
    else:
        jins = (jfw, *jdk.pe_and_tangents(jcoords, w["jspec"]), jcd, jnwp)
        tins = (tfw, *tdk.pe_and_tangents(tcoords, w["tspec"]), tcd, tnwp)
    return jins, tins, f


def _no_bounds(specs, names=("q2", "rio")):
    return tuple(dataclasses.replace(s, bound=None) if s.name in names else s for s in specs)


@pytest.mark.parametrize("case", ["clip", "ragged", "no_clip", "no_bounds"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [4, 6])
def test_residual_sums_match_pallas_kernel(world, version, dtype, case):  # noqa: F811
    """``fused_residual_sums_v4`` / ``_v6`` on CPU tensors (their plain versions)
    against the Pallas kernels; 50 points are ragged against the block of 32."""
    n = 50 if case == "ragged" else 64
    jins, tins, f = _decode_inputs(world, n, version)
    jspecs, tspecs = world["jspecs"], world["tspecs"]
    if case == "no_bounds":  # a spec without bounds is not clipped, whatever with_clip says
        jspecs, tspecs = _no_bounds(jspecs), _no_bounds(tspecs)
    with_clip = case != "no_clip"
    jfn, tfn = ((jrk.fused_residual_sums_v6, trk.fused_residual_sums_v6) if version == 6 else
                (jrk.fused_residual_sums_v4, trk.fused_residual_sums_v4))
    want = np.asarray(jfn(*jins, jnp.asarray(f), jspecs, with_clip=with_clip, block_n=BLOCK, interpret=True,
                          compute_dtype=getattr(jnp, dtype)))
    before = tfn.launches
    got = tfn(*tins, _t(f), tspecs, with_clip=with_clip, compute_dtype=getattr(torch, dtype))
    assert tfn.launches == before  # no kernel was launched
    assert tuple(got.shape) == (6,) and got.dtype == torch.float32 and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype])


# 1, 65 and 129: the point-block edges of the CUDA kernel (64 points a block in bfloat16, 32 in
# float32), where chip_smoke.py and the card test hold it to these plain versions
EDGE_SIZES = (1, 65, 129)


@pytest.fixture(scope="module")
def edge_world(world):  # noqa: F811
    """The world's model at max(EDGE_SIZES) seeded points of its window (the world has 96)."""
    rng = np.random.RandomState(21)
    n = max(EDGE_SIZES)
    coords = np.stack([rng.rand(n) * 27000 * 256, rng.rand(n) * 27000 * 144,
                       rng.randint(0, 25, n) * 3600.0], -1).astype(np.float32)
    return dict(world, coords=coords, nwp=(rng.randn(n, 6) * 0.1).astype(np.float32),
                f=(1e-4 * rng.rand(n, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def pallas_point_sums(edge_world):
    """The Pallas kernels (interpret mode) on each point of ``edge_world`` alone, traced once per
    version and dtype: a one-point call under ``jax.vmap`` over the points.  Each point's six
    squared residuals depend on that point alone, so the sums of the first n rows are the
    kernel's sums over the first n points.  Returns ``get(version, dtype)`` -> [n, 6] float64."""
    cache = {}

    def get(version, dtype):
        if (version, dtype) not in cache:
            jins, _, f = _decode_inputs(edge_world, max(EDGE_SIZES), version)
            fw, pts = jins[0], (*jins[1:], jnp.asarray(f))
            # the point axis of each operand: v4 pe, dpe, cd, ref, f; v6 trig, cd, ref, f
            axes = (0, 1, 0, 0, 0) if version == 4 else (1, 0, 0, 0)
            jfn = jrk.fused_residual_sums_v4 if version == 4 else jrk.fused_residual_sums_v6

            def one(*p):
                return jfn(fw, *(jnp.expand_dims(x, a) for x, a in zip(p, axes)), edge_world["jspecs"],
                           block_n=8, interpret=True, compute_dtype=getattr(jnp, dtype))

            cache[version, dtype] = np.asarray(jax.jit(jax.vmap(one, in_axes=axes))(*pts), np.float64)
        return cache[version, dtype]

    return get


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [4, 6])
def test_residual_sums_match_pallas_kernel_at_block_edges(edge_world, pallas_point_sums, version, dtype, n):
    """``fused_residual_sums_v4`` / ``_v6`` on CPU tensors (their plain versions) against the
    Pallas kernels at the CUDA kernel's point-block edges."""
    _, tins, f = _decode_inputs(edge_world, n, version)
    tfn = trk.fused_residual_sums_v6 if version == 6 else trk.fused_residual_sums_v4
    before = tfn.launches
    got = tfn(*tins, _t(f), edge_world["tspecs"], compute_dtype=getattr(torch, dtype))
    assert tfn.launches == before  # no kernel was launched
    want = pallas_point_sums(version, dtype)[:n].sum(0)
    assert tuple(got.shape) == (6,) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype])


def test_clip_mask_and_bounds_change_the_sums(world):  # noqa: F811
    """The cases above are not vacuous: with the conditioning values pushed past the
    lower bounds of q and rho, clipping changes the sums, and so does dropping the bounds."""
    _, tins, f = _decode_inputs(world, 64, 6)
    fw, trig, cd_pe, ref = tins
    ref = ref.clone()
    ref[::3, 4], ref[1::3, 5] = -3.0, -9.0  # the decode's head adds ref: q and rho far below their bounds
    specs = world["tspecs"]
    clip = trk.fused_residual_sums_v6(fw, trig, cd_pe, ref, _t(f), specs, compute_dtype=torch.float32)
    no_clip = trk.fused_residual_sums_v6(fw, trig, cd_pe, ref, _t(f), specs, with_clip=False,
                                         compute_dtype=torch.float32)
    no_bounds = trk.fused_residual_sums_v6(fw, trig, cd_pe, ref, _t(f),
                                           _no_bounds(specs, ("PSFC", "t2", "q2", "rio")),
                                           compute_dtype=torch.float32)
    assert not np.allclose(clip.numpy(), no_clip.numpy(), rtol=1e-3)
    np.testing.assert_array_equal(no_bounds.numpy(), no_clip.numpy())  # u and v never clip


def test_point_terms_sum_to_the_plain_sums_and_skip_nothing(world):  # noqa: F811
    _, tins, f = _decode_inputs(world, 50, 4)
    fw, pe, dpe, cd_pe, ref = tins
    primal, tang = tdk.decode_jvp_v4_ref(fw, pe, dpe, cd_pe, ref, torch.float32)
    terms = trk.residual_point_terms(primal, tang, _t(f), world["tspecs"])
    assert tuple(terms.shape) == (6, 50) and bool((terms >= 0).all())
    sums = trk.residual_sums_v4_ref(fw, pe, dpe, cd_pe, ref, _t(f), world["tspecs"], compute_dtype=torch.float32)
    np.testing.assert_allclose(sums.numpy(), terms.double().sum(1).numpy(), rtol=1e-5)


@pytest.mark.parametrize("with_clip", [True, False])
@pytest.mark.parametrize("n", [64, 50])
@pytest.mark.parametrize("version", [4, 6])
def test_kernel_residual_losses_matches_jax(world, version, n, with_clip):  # noqa: F811
    w, jargs, targs, f = _points(world, n)
    want = jrk.kernel_residual_losses(*jargs, jnp.asarray(f), w["jspec"], w["jspecs"], FACTORS,
                                      with_clip=with_clip, interpret=True, block_n=BLOCK, version=version)
    got = trk.kernel_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"], FACTORS, with_clip=with_clip,
                                     version=version)
    assert sorted(got) == sorted(want) and len(got) == 7
    for k, v in want.items():
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL["float32"], err_msg=k)


@pytest.mark.parametrize("version", [4, 6])
def test_kernel_residual_losses_matches_the_ports_split_path(world, version):  # noqa: F811
    """In-kernel assembly against decode + assembly in PyTorch, on the same points."""
    w, _, targs, f = _points(world, 96)
    fused = trk.kernel_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"], FACTORS, version=version)
    with torch.no_grad():
        _, fd = tengine.fused_kernel_fields(*targs, w["tspec"], w["tspecs"], version=version)
        split = tengine.residual_losses_from_fields(fd, _t(f), FACTORS)
    for k, v in split.items():
        np.testing.assert_allclose(float(fused[k]), float(v), rtol=1e-5, err_msg=k)
    if version == 4:  # the var-major split path that fused_residual_losses(version=4) takes
        packed = tengine.fused_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"], FACTORS, version=4)
        for k, v in packed.items():
            np.testing.assert_allclose(float(fused[k]), float(v), rtol=1e-5, err_msg=k)


def test_non_mean_norm_spec_raises(world):  # noqa: F811
    w, _, targs, f = _points(world, 8)
    specs = tuple(dataclasses.replace(s, norm_type="min_max") if s.name == "t2" else s for s in w["tspecs"])
    for version in (4, 6):
        with pytest.raises(NotImplementedError, match="mean_norm only.*min_max.*t2"):
            trk.kernel_residual_losses(*targs, _t(f), w["tspec"], specs, FACTORS, version=version)
    with pytest.raises(ValueError, match="six variables"):
        trk.kernel_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"][:5], FACTORS)


def test_fused_residual_losses_v6_dispatches_at_the_crossover(world, monkeypatch):  # noqa: F811
    """Both sides of ``FUSED_ASSEMBLY_MIN_N``, in both packages, as
    tests/test_residual_kernel.py pins the dispatch: below it the split path of the v6
    forward kernel, at or above it the in-kernel assembly."""
    assert tengine.FUSED_ASSEMBLY_MIN_N == jengine.FUSED_ASSEMBLY_MIN_N == 49152
    w, jargs, targs, f = _points(world, 64)
    out = {}
    calls = []
    monkeypatch.setattr(tengine, "kernel_residual_losses",
                        lambda *a, **k: calls.append(k["version"]) or trk.kernel_residual_losses(*a, **k))
    for side, min_n in (("split", 10**9), ("fused", 64)):
        monkeypatch.setattr(jengine, "FUSED_ASSEMBLY_MIN_N", min_n)
        monkeypatch.setattr(tengine, "FUSED_ASSEMBLY_MIN_N", min_n)
        want = jengine.fused_residual_losses(*jargs, jnp.asarray(f), w["jspec"], w["jspecs"], FACTORS,
                                             interpret=True, version=6)
        got = tengine.fused_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"], FACTORS, version=6)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL["float32"], err_msg=f"{side} {k}")
        out[side] = got
    assert calls == [6]  # only the second call reached the in-kernel assembly (N >= the threshold)
    for k, v in out["split"].items():
        np.testing.assert_allclose(float(out["fused"][k]), float(v), rtol=1e-5, err_msg=k)
    # versions 4 and 7 never dispatch to it, whatever the size
    monkeypatch.setattr(tengine, "FUSED_ASSEMBLY_MIN_N", 1)
    for version in (4, 7):
        tengine.fused_residual_losses(*targs, _t(f), w["tspec"], w["tspecs"], FACTORS, version=version)
    assert calls == [6]


# ---- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


# The point-block edges of the kernel (64 points a block in bfloat16, 32 in float32) and 1,000
CARD_SIZES = (1, 17, 64, 65, 129, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [4, 6])
def test_residual_kernel_matches_plain(cuda_device, version, dtype):
    """The CUDA kernel against its plain version at the kernel's widths and CARD_SIZES, one launch a
    call, twice (bit-equal).  Bounds: float32 1e-4 per equation (summation order); bfloat16
    chip_smoke.py's RTOL_RESIDUAL, 2e-3 (the tensor cores' order, recomputed in the plain
    version's near a bf16 tie)."""
    from tests.test_torch_port_engine import OBS_CFG
    from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg

    rng = np.random.RandomState(12)
    n_max, in_ch, hid, two_f = max(CARD_SIZES), 192, 256, 64
    td = getattr(torch, dtype)
    specs = tuple(norm_specs_from_cfg(OBS_CFG)[k] for k in OBS_NAME_ORDER)

    def r(*s, scale=0.05):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(cuda_device)

    shared = dict(b1=r(6, hid), w2f1=r(6, hid, hid), wdf1=r(6, in_ch, hid), rbias=r(6, hid), fw2=r(6, hid),
                  w2wo=r(6, hid), wdwo=r(6, in_ch), obias=r(6))
    cd, ref, f = r(n_max, in_ch, scale=1.0), r(n_max, 6, scale=0.1), r(n_max, 1, scale=1e-4)
    if version == 6:
        fw = tdk.FusedDecodeWeightsV6(w1g=r(6, 3, two_f, hid), w1t=r(6, 3, two_f, hid, scale=1e-6), **shared)
        rows = (r(3, n_max, two_f, scale=1.0),)
        fn, plain = trk.fused_residual_sums_v6, trk.residual_sums_v6_ref
    else:
        w1 = r(6, in_ch, hid)
        fw = tdk.FusedDecodeWeights(w1=w1, w1c=tdk.slice_tangent_weights(w1), **shared)
        rows = (r(n_max, in_ch, scale=1.0), r(3, n_max, two_f, scale=1e-5))
        fn, plain = trk.fused_residual_sums_v4, trk.residual_sums_v4_ref
    for n in CARD_SIZES:
        pts = tuple((x[:n] if x.shape[0] == n_max else x[:, :n]).to(td).contiguous() for x in rows)
        args = (fw, *pts, cd[:n].to(td).contiguous(), ref[:n].contiguous(), f[:n].contiguous(), specs)
        before = fn.launches
        got, again = fn(*args, compute_dtype=td), fn(*args, compute_dtype=td)
        torch.cuda.synchronize()
        assert fn.launches == before + 2 and torch.equal(got, again), n
        np.testing.assert_allclose(got.cpu().numpy(), plain(*args, compute_dtype=td).cpu().numpy(),
                                   rtol=1e-4 if dtype == "float32" else 2e-3, err_msg=str(n))
