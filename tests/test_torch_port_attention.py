"""PyTorch port against the JAX package: attention (``ops/attention.py``) and the
encoder's ``attn_impl`` paths.

Inputs come from numpy with a seed and go through both packages.  Where the JAX
function reaches a Pallas kernel, ``pl.pallas_call`` runs in interpret mode, as
tests/test_attention.py does; the port's wrappers run their plain versions on CPU
tensors.

Tolerances.  float32: 1e-5 on outputs of size 1 (the same function, float32 sums
in another order).  bfloat16: one bf16 step of the largest output: both sides
round at the same places, so a summation difference can at most flip one
rounding.  Gradients in bf16: one bf16 step of the largest entry, and at most
0.1% of the entries more than one step of their own size off (what the
summation order alone does; the rounding fault C14 put 14% there).
"""

import functools
import inspect
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import attention as jattn

from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops import attention as tattn
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)


def _interpret():
    return mock.patch.object(jattn.pl, "pallas_call", functools.partial(jattn.pl.pallas_call, interpret=True))


def _draws(seed, shape, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _inputs(seed, shape, dtype, n=3):
    xs = _draws(seed, shape, n)
    return ([jnp.asarray(x, getattr(jnp, dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


def _np(x):
    return np.asarray(x.float().detach().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _bf16_step(x) -> float:
    """The spacing of bfloat16 numbers at the largest |x|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= _bf16_step(want)


# ---- the plain versions against the Pallas kernels ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["tile", "flash"])
def test_plain_version_matches_pallas_kernel(kernel, dtype):
    """The single-tile kernel at a ragged 37 tokens (padded keys masked); the flash
    kernel at 300 tokens in blocks of 128, as tests/test_attention.py runs it."""
    length = 37 if kernel == "tile" else 300
    (q, k, v), (tq, tk, tv) = _inputs(1, (1, length, 2, 16), dtype)
    scale = 0.25
    with _interpret():
        if kernel == "tile":
            want = jattn._attention_pallas(q, k, v, scale)
        else:
            want = jattn._attention_flash(q, k, v, scale, block_q=128, block_k=128)
    if kernel == "tile":
        got = tattn.attention_tile_ref(tq, tk, tv, scale)
    else:
        got = tattn.attention_flash_ref(tq, tk, tv, scale, block_q=128, block_k=128)
    assert got.dtype == tq.dtype
    _assert_close(got, want, dtype)
    # on CPU tensors the wrappers are their plain versions
    wrapper = tattn.attention_tile if kernel == "tile" else tattn.attention_flash
    launches = wrapper.launches
    assert torch.equal(wrapper(tq, tk, tv, scale), got if kernel == "tile" else
                       tattn.attention_flash_ref(tq, tk, tv, scale))
    assert wrapper.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("kernel,length", [("tile", 1), ("tile", 257), ("flash", 257), ("flash", 513)])
def test_plain_version_matches_pallas_kernel_at_tiling_edges(kernel, length, head_dim, dtype):
    """The plain versions, which chip_smoke.py holds the CUDA kernels to, against the Pallas
    kernels in interpret mode where the CUDA kernels' tiling has edges: head widths 16 and 64
    (one and four k16 steps of the tensor-core products, beside the 32 above); one token (a key
    tile of one real key, the rest zero-filled); 257 tokens (one key past the first 256-key
    tile); the flash kernel with JAX's default 256-key block at 257 and 513 tokens (a last
    block of one key)."""
    (q, k, v), (tq, tk, tv) = _inputs(length + head_dim, (1, length, 2, head_dim), dtype)
    scale = 1.0 / np.sqrt(head_dim)
    with _interpret():
        want = (jattn._attention_pallas if kernel == "tile" else jattn._attention_flash)(q, k, v, scale)
    got = (tattn.attention_tile_ref if kernel == "tile" else tattn.attention_flash_ref)(tq, tk, tv, scale)
    assert got.dtype == tq.dtype
    _assert_close(got, want, dtype)


def test_flash_key_block_is_jax_default_and_sets_the_rounding():
    """``FLASH_BLOCK`` is the default ``block_k`` of JAX's ``_attention_flash``, and the key
    block is part of the flash kernel's function: ``p = exp(s - m_cur)`` is rounded to bf16
    with ``m_cur`` the running max after the WHOLE block, so the same online softmax over
    64-key blocks rounds other p and differs on some bf16 entries (in float32 it is the same
    function).  This is why the CUDA kernel takes each 256-key block's max over all its keys
    before it forms any p of the block, and may not sub-block its max."""
    assert tattn.FLASH_BLOCK == inspect.signature(jattn._attention_flash).parameters["block_k"].default
    _, (q, k, v) = _inputs(9, (1, 600, 2, 32), "float32")
    _assert_close(tattn.attention_flash_ref(q, k, v, 0.5, block_k=64), tattn.attention_flash_ref(q, k, v, 0.5),
                  "float32")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    full = _np(tattn.attention_flash_ref(qb, kb, vb, 0.5))
    sub = _np(tattn.attention_flash_ref(qb, kb, vb, 0.5, block_k=64))
    assert np.mean(full != sub) > 1e-3


def test_tile_kernel_is_the_plain_path_and_flash_rounds_elsewhere():
    """The single-tile kernel computes ``attention_xla``'s function.  The flash kernel
    rounds the unnormalised probabilities: the same function in float32, another
    rounding in bf16 (ROADMAP C15)."""
    (_, (q, k, v)) = _inputs(2, (1, 300, 2, 16), "float32")
    scale = 0.25
    x = tattn.attention_xla(q, k, v, scale)
    _assert_close(tattn.attention_tile_ref(q, k, v, scale), x, "float32")
    _assert_close(tattn.attention_flash_ref(q, k, v, scale), x, "float32")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    xb = _np(tattn.attention_xla(qb, kb, vb, scale))
    assert np.abs(_np(tattn.attention_tile_ref(qb, kb, vb, scale)) - xb).max() <= _bf16_step(xb)
    flash = _np(tattn.attention_flash_ref(qb, kb, vb, scale))
    assert np.mean(np.abs(flash - xb) > 0) > 0.05  # not a summation-order difference
    assert np.abs(flash - xb).max() <= 8 * _bf16_step(xb)


# ---- routing --------------------------------------------------------------------------

def test_routing_matches_jax(monkeypatch):
    """``impl='pallas'`` sends L > _FLASH_THRESHOLD to the flash kernel and the rest to
    the single-tile kernel; ``'flash'`` always takes the flash kernel; ``'xla'`` neither."""
    assert (tattn._FLASH_THRESHOLD, tattn._XLA_SEQ_THRESHOLD) == (jattn._FLASH_THRESHOLD,
                                                                 jattn._XLA_SEQ_THRESHOLD)
    calls = []
    monkeypatch.setattr(tattn, "attention_flash", lambda q, k, v, s: calls.append("flash") or q)
    monkeypatch.setattr(tattn, "attention_tile", lambda q, k, v, s: calls.append("tile") or q)
    for length, impl, want in ((tattn._FLASH_THRESHOLD + 1, "pallas", ["flash"]), (64, "pallas", ["tile"]),
                               (tattn._FLASH_THRESHOLD, "pallas", ["tile"]), (64, "flash", ["flash"]),
                               (tattn._FLASH_THRESHOLD + 1, "xla", []), (tattn._FLASH_THRESHOLD + 1, None, [])):
        calls.clear()
        q = torch.zeros((1, length, 2, 8))
        tattn.fused_attention(q, q, q, 0.5, impl)
        assert calls == want, (length, impl)


def test_default_impl_matches_jax(monkeypatch):
    """JAX's choice on the TPU is the port's on a CUDA device; off it, both are 'xla'."""
    lengths = (287, tattn._XLA_SEQ_THRESHOLD, tattn._XLA_SEQ_THRESHOLD + 1, 4096, None)
    off = [jattn.default_impl(n) for n in lengths]
    assert [tattn.default_impl(n, "cpu") for n in lengths] == off == ["xla"] * len(lengths)
    assert [tattn.default_impl(n) for n in lengths] == off
    monkeypatch.setattr(jattn, "_HAS_PLTPU", True)
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    assert [tattn.default_impl(n, "cuda") for n in lengths] == [jattn.default_impl(n) for n in lengths] \
        == ["xla", "xla", "pallas", "pallas", "pallas"]


# ---- the custom VJP -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_gradients_match_jax_custom_vjp(dtype):
    """C14: q, k, v gradients against ``jax.vjp`` of ``fused_attention(..., 'xla')`` at the
    flagship's shape.  Autograd of ``attention_xla`` rounded elsewhere than JAX's
    ``_fused_bwd`` (dq 5.0e-3 off against a largest entry of 0.77, 14% of the entries
    more than one bf16 step off); ``FusedAttention`` rounds where it does."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(0, (1, 287, 8, 32), dtype, n=4)
    scale = 1.0 / np.sqrt(32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.fused_attention(a, b, c, scale, "xla"), q, k, v)
    want = vjp(g)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got_out = tattn.fused_attention(*leaves, scale, "xla")
    got_out.backward(tg)
    _assert_close(got_out, out, dtype)
    for name, leaf, w in zip("qkv", leaves, want):
        got, w = _np(leaf.grad), _np(w)
        assert leaf.grad.dtype == leaf.dtype, name
        if dtype == "float32":
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=2e-6, err_msg=name)
        else:
            d = np.abs(got - w)
            assert d.max() <= _bf16_step(w), (name, d.max())
            assert np.mean(d > 2.0 ** -7 * np.abs(w)) <= 1e-3, name
    # the backward is the same whichever forward ran
    for impl in ("pallas", "flash", None):
        again = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        tattn.fused_attention(*again, scale, impl).backward(tg)
        assert all(torch.equal(a.grad, b.grad) for a, b in zip(again, leaves)), impl


# ---- PhysicsNet(attn_impl=...) ----------------------------------------------------------

META = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32, activation="gelu",
            learnable_token_num=8)
NET = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)


@pytest.mark.parametrize("impl", ["pallas", "flash"])
def test_encode_with_attn_impl_matches_jax(impl):
    """Tokens and the gradient of a scalar of the tokens, float32: the JAX model with
    the Pallas kernel in interpret mode against the port's with its plain version."""
    rng = np.random.RandomState(5)
    field = rng.randn(2, 12, 65).astype(np.float32)
    fh = np.array([[0.1], [0.3]], np.float32)
    weights = rng.randn(2, 20, 32).astype(np.float32)
    jm = JaxPhysicsNet(meta_cfg=META, net_cfg=NET, attn_impl=impl)

    def scalar(p):
        tokens = jm.apply(p, jnp.asarray(field), jnp.asarray(fh), method=JaxPhysicsNet.encode)
        return jnp.sum(tokens * weights), tokens

    with _interpret():
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(field), jnp.ones((4, 192)), jnp.ones((4, 6)),
                         jnp.asarray(fh[:1]))
        (_, want), grads = jax.jit(jax.value_and_grad(scalar, has_aux=True))(params)
    model = PhysicsNet(META, NET, device="cpu", attn_impl=impl)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert all(layer.attention.attn_impl == impl for layer in model.meta_net.model.encoder.attn_layers)
    tokens = model.encode(torch.from_numpy(field), torch.from_numpy(fh))
    np.testing.assert_allclose(_np(tokens), np.asarray(want), rtol=1e-5, atol=1e-5)
    (tokens * torch.from_numpy(weights)).sum().backward()
    want_grads = {k: v.numpy() for k, v in state_dict_from_jax(grads).items() if k.startswith("meta_net.")}
    # the key-projection bias has an exact gradient of zero (softmax is invariant to it):
    # both sides return rounding noise there, held to the scale of the largest gradient
    largest = max(np.abs(w).max() for w in want_grads.values())
    for name, p in model.named_parameters():
        if name in want_grads:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=1e-4, atol=1e-6 * largest,
                                       err_msg=name)


# ---- devices ----------------------------------------------------------------------------

def test_wrappers_have_no_kernel_off_cpu_and_cuda():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    for wrapper in (tattn.attention_tile, tattn.attention_flash):
        with pytest.raises(ValueError, match="no kernel"):
            wrapper(q, q, q, 0.25)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_match_plain(cuda_device, dtype, head_dim):
    """Both CUDA kernels against their plain versions at every head width: one token and 3 (a
    partial key tile), 287 and 300 (either side of a 256-key block), 1,024 (the single-tile
    kernel's routing limit), 1,025 and 4,096 (the flash kernel's range, a ring of key tiles)."""
    for length in (1, 3, 287, 300, 1024, 1025, 4096):
        # the draws of _inputs, without its JAX arrays (the card's machine has no JAX)
        q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
                   for x in _draws(length, (2, length, 8, head_dim)))
        for wrapper, plain in ((tattn.attention_tile, tattn.attention_tile_ref),
                               (tattn.attention_flash, tattn.attention_flash_ref)):
            before = wrapper.launches
            got = wrapper(q, k, v, 0.2)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            _assert_close(got.cpu(), plain(q, k, v, 0.2).cpu(), dtype)
