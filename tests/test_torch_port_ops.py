"""PyTorch port (deepphysinet_tpu_torch) against the JAX package: ops and model.

The same numpy inputs, made from a seed, go through the JAX function and its
port counterpart.  Pallas kernels run as the JAX tests run them on the CPU
(interpret mode).  Tolerances: float32 elementwise ops agree to a few ulp;
float32 matmul chains use the bar of tests/test_decode_kernel_v4t.py
(rtol 2e-4 / atol 2e-5) unless a comment says why a case needs more.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import coords as jcoords
from deepphysinet_tpu.ops import decode_kernel as jdk
from deepphysinet_tpu.ops import normalization as jnorm
from deepphysinet_tpu.ops import position_encoding as jpe
from deepphysinet_tpu.train import point_fn as jpoint
from deepphysinet_tpu.train.torch_import import export_torch_state_dict

from deepphysinet_tpu_torch.models.init import init_parameters
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops import coords as tcoords
from deepphysinet_tpu_torch.ops import decode_kernel as tdk
from deepphysinet_tpu_torch.ops import normalization as tnorm
from deepphysinet_tpu_torch.ops import position_encoding as tpe
from deepphysinet_tpu_torch.train import point_fn as tpoint
from deepphysinet_tpu_torch.train.torch_import import load_pth, state_dict_from_jax

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

META = dict(enc_in=50, c_out=24, d_model=24, n_heads=4, e_layers=2, d_ff=24,
            activation="gelu", learnable_token_num=6)
NET = dict(in_channels=192, hidden_channels=24, learnable_token_num=10, token_num=9)
COORD = dict(lon_size=257, lat_size=145, dx=27000.0, dy=27000.0, pred_t_span=86400.0)


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x)


# ---- position encoding, coords, normalization ------------------------------

@pytest.mark.parametrize("include_input", [False, True])
def test_sinecos_pe_matches_jax(include_input):
    rng = np.random.RandomState(0)
    x = rng.randn(37, 3).astype(np.float32) * 3
    fb = jpe.make_freq_bands(32)
    np.testing.assert_array_equal(fb, tpe.make_freq_bands(32))
    np.testing.assert_array_equal(jpe.make_freq_bands(8, log_sampling=False),
                                  tpe.make_freq_bands(8, log_sampling=False))
    want = np.asarray(jpe.sinecos_pe(jnp.asarray(x), fb, include_input))
    got = _np(tpe.sinecos_pe(torch.from_numpy(x), fb, include_input))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("column", [False, True])
def test_encode_coord_matches_jax(column):
    rng = np.random.RandomState(1)
    n = 50
    x = (rng.rand(n) * 27000 * 256).astype(np.float32)
    y = (rng.rand(n) * 27000 * 144).astype(np.float32)
    t = (rng.rand(n) * 86400).astype(np.float32)
    if column:
        x, y, t = x[:, None], y[:, None], t[:, None]
    want = jcoords.encode_coord(jnp.asarray(x), jnp.asarray(y), jnp.asarray(t),
                                jcoords.CoordSpec(**COORD))
    got = tcoords.encode_coord(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
                               tcoords.CoordSpec(**COORD))
    assert tcoords.OMEGA == jcoords.OMEGA
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("step", [1.0, 0.25])
def test_make_latlon_grid_matches_jax(step):
    for a, b in zip(jcoords.make_latlon_grid(step=step), tcoords.make_latlon_grid(step=step)):
        np.testing.assert_array_equal(a, b)


NORM_CFGS = {
    "mean": dict(name="t2", norm_factor=[283.58054561520305, 15.583177935722373],
                 norm_type="mean_norm", bound=[250.0, 300.0]),
    "minmax2": dict(name="a", norm_factor=[-3.0, 7.5], norm_type="min_max", bound=[0.0, 5.0]),
    "minmax3": dict(name="b", norm_factor=[0.1, 2.0, 1e-3], norm_type="min_max"),
    "off": dict(name="c", use_norm=False),
}


@pytest.mark.parametrize("key", sorted(NORM_CFGS))
@pytest.mark.parametrize("with_clip", [False, True])
def test_inverse_normalize_matches_jax(key, with_clip):
    x = np.random.RandomState(2).randn(64).astype(np.float32) * 3
    jspec = jnorm.norm_specs_from_cfg({key: NORM_CFGS[key]})[key]
    tspec = tnorm.norm_specs_from_cfg({key: NORM_CFGS[key]})[key]
    want = np.asarray(jnorm.inverse_normalize(jnp.asarray(x), jspec, with_clip))
    got = _np(tnorm.inverse_normalize(torch.from_numpy(x), tspec, with_clip))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_inverse_norm_stack_t_matches_jax():
    import os

    from deepphysinet_tpu.config import Config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(repo, "configs", "DeepPhysiNet_NCEP_cfg.py"))["config"]["obs_norm_cfg"]
    assert tnorm.OBS_NAME_ORDER == jnorm.OBS_NAME_ORDER
    jspecs = tuple(jnorm.norm_specs_from_cfg(cfg)[k] for k in jnorm.OBS_NAME_ORDER)
    tspecs = tuple(tnorm.norm_specs_from_cfg(cfg)[k] for k in tnorm.OBS_NAME_ORDER)
    # +-400 normalized units pushes every clipped variable past its bounds
    x = (np.random.RandomState(3).randn(6, 300) * 400).astype(np.float32)
    for clip in (False, True):
        want = np.asarray(jpoint.inverse_norm_stack_t(jnp.asarray(x), jspecs, clip))
        got = _np(tpoint.inverse_norm_stack_t(torch.from_numpy(x), tspecs, clip))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.abs(_np(tpoint.inverse_norm_stack_t(torch.from_numpy(x), tspecs, True))[:2]).max() > 500


# ---- the decode kernel's inputs and plain version --------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_primal_matches_pe_and_tangents(dtype):
    rng = np.random.RandomState(4)
    n = 300
    coords = np.stack([rng.rand(n) * 27000 * 256, rng.rand(n) * 27000 * 144,
                       rng.rand(n) * 86400], -1).astype(np.float32)
    want, _ = jdk.pe_and_tangents(jnp.asarray(coords), jcoords.CoordSpec(**COORD),
                                  dtype=getattr(jnp, dtype))
    got = tdk.pe_primal(torch.from_numpy(coords), tcoords.CoordSpec(**COORD),
                        dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    # f32: sin/cos of angles up to 16 rad differ by a few ulp between XLA and
    # torch; bf16: such a difference can flip one rounding (1 bf16 ulp = 2^-8)
    atol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0, atol=atol)


N_DEC, IN_CH, HID, NV = 300, 48, 32, 6


def _fused_inputs(seed=7, n=N_DEC):
    rng = np.random.RandomState(seed)

    def r(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    fw = dict(w1=r(NV, IN_CH, HID), b1=r(NV, HID), w2f1=r(NV, HID, HID), wdf1=r(NV, IN_CH, HID),
              rbias=r(NV, HID), fw2=r(NV, HID), w2wo=r(NV, HID), wdwo=r(NV, IN_CH), obias=r(NV))
    return fw, r(n, IN_CH), r(n, IN_CH), r(NV, n)


def _jax_fw(fw):
    return jdk.FusedDecodeWeights(w1c=jnp.zeros((NV, 3, IN_CH // 3, HID)),
                                  **{k: jnp.asarray(v) for k, v in fw.items()})


def _torch_fw(fw):
    fw = {k: torch.from_numpy(v) for k, v in fw.items()}
    return tdk.FusedDecodeWeights(w1c=tdk.slice_tangent_weights(fw["w1"]), **fw)


@functools.lru_cache(maxsize=None)
def _jax_primal(dtype):
    """The Pallas kernel (interpret) and its XLA twin on the N_DEC points of ``_fused_inputs()``,
    once per dtype: each point's output depends on its own inputs only, so a case at n points
    reads the first n."""
    fw, pe, cd, ref_t = _fused_inputs()
    jd = getattr(jnp, dtype)
    # the decode path feeds both in the compute dtype
    pe_j, cd_j = jnp.asarray(pe).astype(jd), jnp.asarray(cd).astype(jd)
    k = jdk.decode_primal_v4t(_jax_fw(fw), pe_j, cd_j, jnp.asarray(ref_t), block_n=128,
                              interpret=True, compute_dtype=jd)
    x = jdk.decode_xla_v4t_primal(_jax_fw(fw), pe_j, cd_j, jnp.asarray(ref_t), jd)
    return np.asarray(k), np.asarray(x)


# N_DEC points, and the point-block edges of the port's tensor-core kernel (128 points a
# block; 64 for float32), where chip_smoke.py holds it to this plain version
@pytest.mark.parametrize("dtype, n", [pytest.param(d, N_DEC, id=d) for d in ("float32", "bfloat16")] + [
    pytest.param(d, n, id=f"{d}-{n}") for d in ("float32", "bfloat16") for n in (1, 17, 64, 65, 129)])
def test_decode_primal_ref_matches_jax(dtype, n):
    """decode_primal_v4t_ref == the Pallas kernel (interpret) == its XLA twin."""
    fw, pe, cd, ref_t = _fused_inputs()
    td = getattr(torch, dtype)
    pe_t, cd_t = torch.from_numpy(pe[:n]).to(td), torch.from_numpy(cd[:n]).to(td)
    k, x = (a[:, :n] for a in _jax_primal(dtype))
    got = _np(tdk.decode_primal_v4t_ref(_torch_fw(fw), pe_t, cd_t, torch.from_numpy(ref_t[:, :n]), td))
    assert got.shape == (NV, n)
    if dtype == "float32":
        tol = dict(rtol=2e-4, atol=2e-5)
    else:
        # same rounding points on both sides (measured max |diff| 1.4e-6 at
        # |out| ~ 8); the bound leaves room for a summation-order difference
        # to flip one bf16 rounding of p (2^-8 of one term) before w2f1
        tol = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, k, **tol)
    np.testing.assert_allclose(got, x, **tol)


def test_decode_primal_wrapper_takes_plain_path_on_cpu():
    fw, pe, cd, ref_t = _fused_inputs(seed=8, n=5)
    args = (_torch_fw(fw), torch.from_numpy(pe), torch.from_numpy(cd), torch.from_numpy(ref_t))
    before = tdk.decode_primal_v4t.launches
    got = tdk.decode_primal_v4t(*args, compute_dtype=torch.float32)
    assert tdk.decode_primal_v4t.launches == before  # no kernel on CPU tensors
    torch.testing.assert_close(got, tdk.decode_primal_v4t_ref(*args, torch.float32),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.decode_primal_v4t(args[0], args[1].to("meta"), args[2], args[3])


# ---- model: weights bridge, encoder, plain decode --------------------------

@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(9)
    model = JaxPhysicsNet(meta_cfg=META, net_cfg=NET)
    field = rng.randn(1, NET["token_num"], META["enc_in"]).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(5), jnp.asarray(field), jnp.zeros((2, 192)),
                           jnp.zeros((2, 6)), jnp.asarray([[0.2]], jnp.float32))
    return model, variables, field


def _port(variables, dtype=torch.float32):
    net = PhysicsNet(META, NET, compute_dtype=dtype, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net


def test_state_dict_from_jax_is_export_torch_state_dict(jax_model):
    _, variables, _ = jax_model
    want = export_torch_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the port's own module tree has exactly these names and shapes
    own = PhysicsNet(META, NET, device="cpu").state_dict()
    assert sorted(own) == sorted(want)
    assert all(tuple(own[k].shape) == v.shape for k, v in want.items())


def test_load_pth_strict_roundtrip(jax_model, tmp_path):
    _, variables, _ = jax_model
    sd = state_dict_from_jax(variables)
    path = str(tmp_path / "physics_3.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}, "epoch": 3,
                "gobal_step": 77}, path)
    got, epoch, step = load_pth(path)
    assert (epoch, step) == (3, 77)
    net = PhysicsNet(META, NET, device="cpu")
    net.load_state_dict(got, strict=True)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_init_parameters_is_seeded():
    a = init_parameters(PhysicsNet(META, NET, device="cpu"), torch.Generator().manual_seed(3)).state_dict()
    b = init_parameters(PhysicsNet(META, NET, device="cpu"), torch.Generator().manual_seed(3)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    tok = a["meta_net.model.learnable_token"]
    assert 0.0 <= float(tok.min()) and float(tok.max()) < 1.0
    w = a["U_net.coord_input_fc.weight"]  # fan_in = learnable_token_num
    assert float(w.abs().max()) <= 1.0 / np.sqrt(NET["learnable_token_num"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(jax_model, dtype):
    model, variables, field = jax_model
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JaxPhysicsNet(meta_cfg=META, net_cfg=NET, compute_dtype=jd)
    fh = np.array([[0.3]], np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(field), jnp.asarray(fh),
                               method=JaxPhysicsNet.encode), np.float32)
    with torch.no_grad():
        got = _port(variables, td).encode(torch.from_numpy(field), torch.from_numpy(fh))
    assert got.dtype == td and tuple(got.shape) == want.shape
    # bf16: XLA rounds gelu's bf16 intermediates where torch keeps float32,
    # and the tokens are bf16 (ulp 2^-7 at |x| in [1, 2)): measured max
    # |diff| 0.0156, two ulps, at |tokens| <= 1.9
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), want, **tol)


def test_encode_rejects_wrong_token_count(jax_model):
    _, variables, field = jax_model
    with pytest.raises(ValueError, match="token_num"):
        _port(variables).encode(torch.from_numpy(field[:, :-1]), torch.zeros(1, 1))


def test_decode_matches_jax(jax_model):
    """The plain per-variable decode (PhysicsNet.decode) at float32."""
    model, variables, field = jax_model
    rng = np.random.RandomState(10)
    fh = np.array([[0.3]], np.float32)
    tokens = model.apply(variables, jnp.asarray(field), jnp.asarray(fh),
                         method=JaxPhysicsNet.encode)[0]
    pe = rng.randn(40, 192).astype(np.float32)
    cd = (rng.randn(40, 6) * 0.2).astype(np.float32)
    want = model.apply(variables, tokens, jnp.asarray(pe), jnp.asarray(cd), jnp.asarray(fh[0]),
                       method=JaxPhysicsNet.decode)
    with torch.no_grad():
        got = _port(variables).decode(torch.from_numpy(np.array(tokens)), torch.from_numpy(pe),
                                      torch.from_numpy(cd), torch.from_numpy(fh[0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-5)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_primal_kernel_matches_plain(cuda_device, dtype):
    """The CUDA kernel against its plain version at the kernel's hidden width, at the
    point-block edges (128 points a block in bf16, 64 in float32), 1,000 points and one
    145 x 257 frame."""
    rng = np.random.RandomState(11)
    n_max, in_ch, hid = 37265, 192, 256
    fw = {
        k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32)).to(cuda_device)
        for k, s in dict(w1=(6, in_ch, hid), b1=(6, hid), w2f1=(6, hid, hid),
                         wdf1=(6, in_ch, hid), rbias=(6, hid), fw2=(6, hid),
                         w2wo=(6, hid), wdwo=(6, in_ch), obias=(6,)).items()}
    fw = tdk.FusedDecodeWeights(w1c=tdk.slice_tangent_weights(fw["w1"]), **fw)
    td = getattr(torch, dtype)
    pe_all = torch.from_numpy(rng.randn(n_max, in_ch).astype(np.float32)).to(cuda_device, td)
    cd_all = torch.from_numpy(rng.randn(n_max, in_ch).astype(np.float32)).to(cuda_device, td)
    ref_all = torch.from_numpy(rng.randn(6, n_max).astype(np.float32)).to(cuda_device)
    # the bounds of chip_smoke.py: same rounding points, float32 summation order
    tol = 1e-5 if dtype == "float32" else 1e-3
    for n in (1, 17, 64, 65, 129, 1000, n_max):
        pe, cd, ref_t = pe_all[:n].contiguous(), cd_all[:n].contiguous(), ref_all[:, :n].contiguous()
        before = tdk.decode_primal_v4t.launches
        got = tdk.decode_primal_v4t(fw, pe, cd, ref_t, td)
        torch.cuda.synchronize()
        assert tdk.decode_primal_v4t.launches == before + 1
        want = tdk.decode_primal_v4t_ref(fw, pe, cd, ref_t, td)
        assert got.shape == (6, n) and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= tol * (1.0 + float(want.abs().max())), n
