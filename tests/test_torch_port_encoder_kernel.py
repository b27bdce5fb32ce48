"""PyTorch port against the JAX package: the fused whole-encoder kernel
(``ops/encoder_kernel.py``).

The cases of tests/test_encoder_kernel.py (gelu f32 and bf16, relu, a sequence
length that is a multiple of 16) plus two batch items: the same weights (JAX init,
carried over with ``state_dict_from_jax``) and the same field (numpy, from a seed)
go through JAX ``encode_fused(..., interpret=True)`` and the port's ``encode_fused``,
whose wrapper runs its plain version on CPU tensors.  The plain version is also
held to the TPU kernel's body, ``_encoder_kernel``, run on plain arrays.

Tolerances.  float32: 2e-5, the JAX test's bar (the same op chain, float32 sums in
another order).  bf16 against the kernel body and against the port's own
``PhysicsNet.encode``: one bf16 step of the largest token, and at most 1% of the
entries more than a step of their own size off (both sides round at the same
places; a summation difference may flip a rounding that later layers carry
along; measured: bit-equal).  bf16 against JAX's interpret mode: the JAX test's
bar, 3e-2 of the largest token.  Pallas' interpreter on the CPU rounds elsewhere
than the kernel body run as plain operations (22% of the tokens more than a
step apart at equal inputs, where the port's plain version and the body agree
to the bit).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import encoder_kernel as jek

from deepphysinet_tpu_torch.models.init import init_parameters
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops import encoder_kernel as tek
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

# name: (compute dtype, e_layers, token_num, activation, batch); learnable tokens 8
CASES = {
    "gelu_f32": ("float32", 2, 12, "gelu", 1),
    "gelu_bf16": ("bfloat16", 2, 12, "gelu", 1),
    "relu_f32": ("float32", 1, 12, "relu", 1),
    "unpadded_f32": ("float32", 1, 24, "gelu", 1),  # L = 32: no padding in the TPU kernel
    "batch2_f32": ("float32", 2, 12, "gelu", 2),
}


def _case(i, name):
    """Case ``name`` (the i-th of CASES): its configs, field and forecast hours."""
    dtype, e_layers, token_num, act, batch = CASES[name]
    rng = np.random.RandomState(i)
    meta = dict(enc_in=65, c_out=64, d_model=64, n_heads=4, e_layers=e_layers, activation=act,
                d_ff=96, learnable_token_num=8)
    net = dict(in_channels=192, hidden_channels=64, learnable_token_num=16, token_num=token_num)
    field = (rng.randn(batch, token_num, 65) * 0.5).astype(np.float32)
    fh = np.full((batch, 1), 0.1, np.float32) + 0.2 * np.arange(batch, dtype=np.float32)[:, None]
    return meta, net, field, fh


@pytest.fixture(scope="module")
def models():
    """Both packages' models and one field per case, built once; cases whose models differ
    only in the compute dtype or the batch share one initialisation (the parameters are
    float32 either way)."""
    out, inits = {}, {}
    for name, (dtype, e_layers, token_num, act, batch) in CASES.items():
        meta, net, field, fh = _case(len(out), name)
        jm = JaxPhysicsNet(meta_cfg=meta, net_cfg=net, compute_dtype=getattr(jnp, dtype))
        key = (e_layers, token_num, act)
        if key not in inits:
            inits[key] = JaxPhysicsNet(meta_cfg=meta, net_cfg=net).init(
                jax.random.PRNGKey(0), jnp.asarray(field[:1]), jnp.zeros((4, 192)), jnp.zeros((4, 6)),
                jnp.asarray(fh[:1]))
        params = inits[key]
        tm = PhysicsNet(meta, net, compute_dtype=getattr(torch, dtype), device="cpu")
        tm.load_state_dict(state_dict_from_jax(params), strict=True)
        out[name] = dict(jm=jm, params=params, tm=tm, field=field, fh=fh, dtype=dtype)
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _assert_tokens_close(got, want, dtype, interpreted=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    elif interpreted:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2 * max(1.0, np.abs(want).max()))
    else:
        step = float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))
        d = np.abs(got - want)
        assert d.max() <= step, d.max()
        assert np.mean(d > 2.0 ** -7 * np.abs(want)) <= 1e-2


def test_extract_encoder_weights_matches_jax(models):
    m = models["gelu_f32"]
    want = jek.extract_encoder_weights(m["jm"], m["params"])
    got = tek.extract_encoder_weights(m["tm"])
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert tuple(got.wq.shape) == (2, 4, 64, 16) and tuple(got.wo.shape) == (2, 4, 16, 64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_fused_matches_jax(models, case):
    m = models[case]
    want = jek.encode_fused(m["jm"], m["params"], jnp.asarray(m["field"]), jnp.asarray(m["fh"]), interpret=True)
    launches = tek.fused_encoder_forward.launches
    got = tek.encode_fused(m["tm"], torch.from_numpy(m["field"]), torch.from_numpy(m["fh"]))
    assert tek.fused_encoder_forward.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (m["field"].shape[0], m["field"].shape[1] + 8, 64)
    _assert_tokens_close(got, want, m["dtype"], interpreted=True)


class _Ref:
    """A Pallas ref stand-in over a plain array, to run the kernel body as plain operations."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, index):
        return self.value[index]

    def __setitem__(self, index, value):
        self.value = value

    shape = property(lambda self: self.value.shape)
    dtype = property(lambda self: self.value.dtype)


@pytest.mark.parametrize("case", ["gelu_f32", "gelu_bf16", "relu_f32"])
def test_plain_version_matches_the_kernel_body(models, case):
    """``fused_encoder_forward_ref`` against ``_encoder_kernel`` on plain arrays, at equal inputs."""
    m = models[case]
    jw = jek.extract_encoder_weights(m["jm"], m["params"])
    cdt, f32 = getattr(jnp, m["dtype"]), jnp.float32
    x = np.random.RandomState(9).randn(m["field"].shape[1] + 8, 64).astype(np.float32)
    refs = [_Ref(jnp.asarray(getattr(jw, k)).astype(cdt if k in tek._MATRICES else f32)) for k in jw._fields]
    out = _Ref(jnp.zeros((x.shape[0], 64), f32))
    act = CASES[case][3]
    jek._encoder_kernel(_Ref(jnp.asarray(x)), *refs, out, n_layers=jw.wq.shape[0], n_heads=4, seq_len=x.shape[0],
                        scale=1.0 / 4.0, cdt=cdt, activation=act)
    got = tek.fused_encoder_forward_ref(tek.extract_encoder_weights(m["tm"]), torch.from_numpy(x), act,
                                        getattr(torch, m["dtype"]))
    _assert_tokens_close(got, out.value, m["dtype"])


# the bf16 kernel's unit edges: one token, 16-row groups (15, 16, 17) and 32-query attention units (33)
UNIT_EDGE_LENGTHS = (1, 15, 16, 17, 33)


@pytest.mark.parametrize("length", UNIT_EDGE_LENGTHS)
@pytest.mark.parametrize("case", ["gelu_f32", "gelu_bf16"])
def test_plain_version_matches_the_kernel_body_at_unit_edges(models, case, length):
    """``fused_encoder_forward_ref`` against ``_encoder_kernel`` on plain arrays at the token counts
    where the bf16 kernel's row groups and attention units begin and end."""
    m = models[case]
    jw = jek.extract_encoder_weights(m["jm"], m["params"])
    cdt, f32 = getattr(jnp, m["dtype"]), jnp.float32
    x = np.random.RandomState(100 + length).randn(length, 64).astype(np.float32)
    refs = [_Ref(jnp.asarray(getattr(jw, k)).astype(cdt if k in tek._MATRICES else f32)) for k in jw._fields]
    out = _Ref(jnp.zeros((length, 64), f32))
    jek._encoder_kernel(_Ref(jnp.asarray(x)), *refs, out, n_layers=jw.wq.shape[0], n_heads=4, seq_len=length,
                        scale=1.0 / 4.0, cdt=cdt, activation="gelu")
    got = tek.fused_encoder_forward_ref(tek.extract_encoder_weights(m["tm"]), torch.from_numpy(x), "gelu",
                                        getattr(torch, m["dtype"]))
    _assert_tokens_close(got, out.value, m["dtype"])


@pytest.mark.parametrize("case", ["gelu_f32", "gelu_bf16", "batch2_f32"])
def test_encode_fused_matches_port_encode(models, case):
    m = models[case]
    field, fh = torch.from_numpy(m["field"]), torch.from_numpy(m["fh"])
    with torch.no_grad():
        want = m["tm"].encode(field, fh)
    _assert_tokens_close(tek.encode_fused(m["tm"], field, fh), want, m["dtype"])


def _random_weights(n_layers, n_heads, d, e, f, c, seed):
    rng = np.random.RandomState(seed)
    shapes = dict(wq=(n_layers, n_heads, d, e), bq=(n_layers, n_heads, e), wk=(n_layers, n_heads, d, e),
                  bk=(n_layers, n_heads, e), wv=(n_layers, n_heads, d, e), bv=(n_layers, n_heads, e),
                  wo=(n_layers, n_heads, e, d), bo=(n_layers, d), ln1s=(n_layers, d), ln1b=(n_layers, d),
                  w1=(n_layers, d, f), b1=(n_layers, f), w2=(n_layers, f, d), b2=(n_layers, d),
                  ln2s=(n_layers, d), ln2b=(n_layers, d), lns=(d,), lnb=(d,), wproj=(d, c), bproj=(c,))
    return tek.EncoderKernelWeights(**{k: torch.from_numpy(rng.randn(*v).astype(np.float32))
                                       for k, v in shapes.items()})


@pytest.mark.parametrize("shape", ["model", "widths_of_8"])
def test_packed_tiles_round_trip_to_extracted_weights(models, shape):
    """``pack_encoder_weights`` (the bf16 kernel's weight tiles) holds every matrix of
    ``extract_encoder_weights`` once, each block's column slice as one tile with zeros past K and
    past the slice, at the offsets it returns: unpacked by ``tile_geometry``, the tiles give back
    each product's matrix bit for bit.  Also at widths that are multiples of 8 and not of 16."""
    w = (tek.extract_encoder_weights(models["gelu_f32"]["tm"]) if shape == "model"
         else _random_weights(2, 3, 72, 24, 40, 56, seed=5))
    n_layers, n_heads, d, e = w.wq.shape
    f, c = w.w1.shape[-1], w.wproj.shape[-1]
    w = tek.cast_encoder_weights(w, torch.bfloat16)
    packed, offsets = tek.pack_encoder_weights(w)
    assert packed.dtype == torch.bfloat16 and offsets.shape == (6 * n_layers + 1, tek.CLUSTER)
    covered = 0
    for p, (m, lay, k, n) in enumerate(tek._product_shapes(n_layers, n_heads, d, e, f, c)):
        if m in ("wq", "wk", "wv"):  # [H, D, E] -> [D, H E]
            want = getattr(w, m)[lay].permute(1, 0, 2).reshape(d, n_heads * e)
        elif m == "wo":
            want = w.wo[lay].reshape(n_heads * e, d)
        else:
            want = getattr(w, m) if m == "wproj" else getattr(w, m)[lay]
        got = torch.zeros_like(want)
        for rank in range(tek.CLUSTER):
            c0, nc, ld, rows = tek.tile_geometry(k, n, rank)
            at = int(offsets[p, rank])
            t = packed[at:at + rows * ld].view(rows, ld)
            assert not t[k:].any() and not t[:, nc:].any(), (m, lay, rank)
            assert rows % 16 == 0 and ld % 8 == 0 and rows * ld * 2 <= tek.SLOT_BYTES
            got[:, c0:c0 + nc] = t[:k, :nc]
            covered += rows * ld
        assert torch.equal(got, want), (m, lay)
    assert covered == packed.numel()


def test_wrapper_has_no_kernel_off_cpu_and_cuda(models):
    m = models["gelu_f32"]
    w = tek.extract_encoder_weights(m["tm"])
    with pytest.raises(ValueError, match="no kernel"):
        tek.fused_encoder_forward(w, torch.zeros((20, 64), device="meta"), "gelu", torch.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def port_models():
    """The port's model and field of each case, as ``models`` builds them but with the port's own
    seeded initialisation for the JAX package's (the card's machine has no JAX; the card test
    holds the port's kernel to the port's plain version, on any weights)."""
    out = {}
    for i, (name, (dtype, *_)) in enumerate(CASES.items()):
        meta, net, field, fh = _case(i, name)
        tm = PhysicsNet(meta, net, compute_dtype=getattr(torch, dtype), device="cpu")
        init_parameters(tm, torch.Generator().manual_seed(i))
        out[name] = dict(tm=tm, field=field, fh=fh, dtype=dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gelu_f32", "gelu_bf16", "relu_f32"])
def test_encoder_kernel_matches_plain(port_models, cuda_device, case):
    m = port_models[case]
    tm = copy.deepcopy(m["tm"]).to(cuda_device)
    net = tm.meta_net.model
    field, fh = torch.from_numpy(m["field"]).to(cuda_device), torch.from_numpy(m["fh"]).to(cuda_device)
    with torch.no_grad():
        x = net.enc_embedding(field, fh, net.learnable_token)[0]
    w, cd = tek.extract_encoder_weights(tm), getattr(torch, m["dtype"])
    act = net.encoder.attn_layers[0].activation
    before = tek.fused_encoder_forward.launches
    got = tek.fused_encoder_forward(w, x, act, cd)
    torch.cuda.synchronize()
    assert tek.fused_encoder_forward.launches == before + 1
    _assert_tokens_close(got.cpu(), tek.fused_encoder_forward_ref(w, x, act, cd).cpu(), m["dtype"])
    # bf16 runs on the tensor-core body (heads of 16), float32 on the CUDA-core body; both also at the
    # token counts where the bf16 body's 16-row groups and 32-query attention units begin and end
    assert tek.kernel_route(tek.cast_encoder_weights(w, cd), x.shape[0], cd) == (16 if cd == torch.bfloat16 else 0)
    tokens = torch.from_numpy(np.random.RandomState(7).randn(max(UNIT_EDGE_LENGTHS), x.shape[1]).astype(np.float32))
    for n in UNIT_EDGE_LENGTHS:
        xn = tokens[:n].to(cuda_device)
        got = tek.fused_encoder_forward(w, xn, act, cd)
        torch.cuda.synchronize()
        _assert_tokens_close(got.cpu(), tek.fused_encoder_forward_ref(w, xn, act, cd).cpu(), m["dtype"])
