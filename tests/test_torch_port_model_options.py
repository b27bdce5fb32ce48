"""PyTorch port against the JAX package: the encoder's model options and the rest of the
model inventory (ROADMAP A8.1-A8.2).

At the tiny dims of tests/test_train_step.py, inputs from numpy seeds, weights carried
from JAX with ``state_dict_from_jax`` (and the ResNet / ``EncoderStack`` maps):

* the numpy copy of ``jax.random.randint(PRNGKey(0), ...)`` bit for bit (C47's draw);
* ``prob_attention`` forward and ``jax.vjp`` gradients, float32 and bf16, and a case of
  tied sparsity scores, where the lower index must win;
* ``PhysicsNet`` with ``attn_type='prob'``, ``fused_qkv=True`` and both: the encode and
  its parameter gradients, and one training step, against JAX's;
* ``EncoderStack``; ResNet-18 and ResNet-50 at 32 x 32, eval and train mode, and the
  running statistics after one train-mode call; ``SineCosPE`` and ``normalize`` in
  every branch; the registries; the flop counts; ``trace``;
* C47 (the same key sample on every call) and C48 (``encode_fused`` refuses a prob
  model).

Tolerances.  float32: rtol 1e-5 (matmul chains in another summation order).  bf16: the
ProbSparse forward is bit for bit against JAX op by op (each einsum rounded, the scale
rounded before it multiplies, the softmax's sum in float32, as JAX).  Its gradients come
from autograd, which sums a bf16 cotangent in float32 where XLA on the CPU sums it in
bf16, term after term: each gradient of ``prob_attention`` within 2e-2 of its largest
magnitude (measured 1.0e-2), each parameter gradient of a bf16 encode within 6e-2
(measured 4.6e-2 at the query projection, where either package's bf16 gradient lies
16-18% from the float32 model's).  A bf16 encode against JAX's jitted one: within 2e-2
of its largest token (measured 7.8e-3; JAX jitted and op by op differ by as much).
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models import backbone as jbackbone
from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.models.transformer_net import EncoderStack as JaxEncoderStack
from deepphysinet_tpu.models.transformer_net import TransformerNet as JaxTransformerNet
from deepphysinet_tpu.ops import normalization as jnorm
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.position_encoding import SineCosPE as JaxSineCosPE
from deepphysinet_tpu.ops.prob_attention import prob_attention as jax_prob_attention
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer
from deepphysinet_tpu.utils import flops as jflops

from deepphysinet_tpu_torch.models import backbone
from deepphysinet_tpu_torch.models.builder import build_model
from deepphysinet_tpu_torch.models.init import init_parameters
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.models.transformer_net import EncoderStack, TransformerNet
from deepphysinet_tpu_torch.ops import normalization as tnorm
from deepphysinet_tpu_torch.ops import prob_attention as pa
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.encoder_kernel import encode_fused
from deepphysinet_tpu_torch.ops.position_encoding import SineCosPE
from deepphysinet_tpu_torch.registry import BACKBONES, MODELS
from deepphysinet_tpu_torch.train import train_step as tts
from deepphysinet_tpu_torch.train.torch_import import (encoder_stack_state_dict_from_jax, load_train_state,
                                                       resnet_state_dict_from_jax, state_dict_from_jax)
from deepphysinet_tpu_torch.utils import flops as tflops
from deepphysinet_tpu_torch.utils.profiling import ThroughputMeter, step_annotation, trace

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

META = dict(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32,
            activation="gelu", learnable_token_num=8)
NET = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)
OPTIONS = {"prob": dict(attn_type="prob"), "fused": dict(fused_qkv=True),
           "both": dict(attn_type="prob", fused_qkv=True)}
RTOL_F32 = 1e-5
PROB_GRAD_SHARE_BF16 = 2e-2
ENCODE_GRAD_SHARE_BF16 = 6e-2
ENCODE_SHARE_BF16 = 2e-2
RTOL_EVAL, RTOL_TRAIN = 1e-5, 1e-3


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _numpy_variables(init, *args, seed=0):
    """Variables of the tree ``init(*args)`` would make, drawn from numpy (``jax.eval_shape``
    traces the init; running it op by op on the CPU would cost seconds for each new shape)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.1 * rng.rand(*shape)).astype(np.float32)
        if name == "learnable_token":
            return rng.rand(*shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, jax.random.PRNGKey(0), *args))


def _seeded(meta, seed=0):
    return init_parameters(PhysicsNet(meta, NET, device="cpu"), torch.Generator().manual_seed(seed))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


# ---- the key sample (C47) --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(287, 30, 287), (4096, 45, 4096), (3, 5, 7), (11, 2, 100_000)],
                         ids=["flagship", "4096_tokens", "small", "wide_span"])
def test_randint_matches_jax_bit_for_bit(shape):
    l_q, u_part, l_k = shape
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (l_q, u_part), 0, l_k))
    got = pa.randint(pa.prng_key(0), (l_q, u_part), 0, l_k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sample_is_the_same_tensor_on_every_call():
    """C47: JAX's encoder draws its key sample with PRNGKey(0) on every call; the port caches
    that draw, and two encodes of a prob model give the same tokens."""
    a = pa.sample_indices(20, 15, 20, "cpu")
    assert a is pa.sample_indices(20, 15, 20, "cpu") and a.dtype == torch.int64
    np.testing.assert_array_equal(a.numpy(), pa.randint(pa.prng_key(0), (20, 15), 0, 20))
    model = _seeded(dict(META, attn_type="prob"))
    field, fh = torch.randn(1, 12, 65, generator=torch.Generator().manual_seed(0)), torch.tensor([[0.1]])
    with torch.no_grad():
        assert torch.isfinite(model.encode(field, fh)).all()
        assert torch.equal(model.encode(field, fh), model.encode(field, fh))


# ---- prob_attention ----------------------------------------------------------------------

def _prob_inputs(case, rng, shape):
    if case == "tied":
        # one-hot queries and keys: every sampled score is 0 or 1, so m = max - mean is exact
        # in both packages and the same for every query with as many sampled matches
        eye = np.eye(shape[-1], dtype=np.float32)
        return ([eye[rng.randint(0, shape[-1], shape[:-1])] for _ in range(2)]
                + [rng.randn(*shape).astype(np.float32) for _ in range(2)])
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_top(q, k):
    """JAX's selected queries, computed as ``prob_attention`` computes them."""
    b, l, h, e = q.shape
    u, u_part = pa.top_counts(l, l)
    qh, kh = jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2)
    ks = kh[:, :, jax.random.randint(jax.random.PRNGKey(0), (l, u_part), 0, l)]
    qk = jnp.einsum("bhle,bhlse->bhls", qh, ks)
    m = jnp.max(qk, axis=-1) - jnp.mean(qk, axis=-1)
    return np.asarray(jax.lax.top_k(m, u)[1]), np.asarray(m.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "tied"])
def test_prob_attention_matches_jax(dtype, case):
    shape = (2, 20, 4, 8)  # the attention's shape in the encode tests below
    q, k, v, g = _prob_inputs(case, np.random.RandomState(0), shape)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    scale = float(1.0 / np.sqrt(shape[-1]))  # a Python float, as the encoder passes it
    jargs = [jnp.asarray(x, jd) for x in (q, k, v)]
    def jax_run(*args):
        want, vjp = jax.vjp(lambda a, b, c: jax_prob_attention(a, b, c, jax.random.PRNGKey(0), scale=scale), *args)
        return want, vjp(jnp.asarray(g, jd))

    # bf16 op by op: jitted, XLA on the CPU may keep float32 between fused operations, where
    # each JAX operation rounds on its own (the port follows the latter); float32 jitted
    want, want_grads = (jax_run if dtype == "bfloat16" else jax.jit(jax_run))(*jargs)
    targs = [_t(x, td).requires_grad_() for x in (q, k, v)]
    got = pa.prob_attention(*targs, scale=scale)
    got.backward(_t(g, td))
    assert got.shape == shape and got.dtype == td

    top, m = _jax_top(*jargs[:2])
    np.testing.assert_array_equal(pa.top_queries(*[t.detach() for t in targs[:2]]).numpy(), top)
    if case == "tied":  # the case does what it is for: many tied scores, ties across the cut
        sorted_m = -np.sort(-m, axis=-1)
        u = top.shape[-1]
        assert (sorted_m[..., u - 1] == sorted_m[..., u]).any()
        assert (np.diff(sorted_m, axis=-1) == 0).sum() >= 10
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL_F32, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))
    for name, t, w in zip("qkv", targs, want_grads):
        w = _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(_np(t.grad), w, rtol=RTOL_F32, atol=1e-6, err_msg=name)
        else:
            err = np.abs(_np(t.grad) - w).max()
            assert err <= PROB_GRAD_SHARE_BF16 * np.abs(w).max(), (name, err, np.abs(w).max())


# ---- the model with the options ------------------------------------------------------------

def _model_pair(options, dtype, seed=0):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(seed)
    field = rng.randn(2, 12, 65).astype(np.float32)
    fh = np.array([[0.1], [0.4]], np.float32)
    meta = dict(META, **options)
    jm = JaxPhysicsNet(meta_cfg=meta, net_cfg=NET, compute_dtype=jd)
    params = _numpy_variables(jm.init, jnp.asarray(field), jnp.ones((4, 192)), jnp.ones((4, 6)),
                              jnp.asarray(fh[:1]), seed=seed)
    model = PhysicsNet(meta, NET, compute_dtype=td, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, model, field, fh


@pytest.mark.parametrize("option, dtype", [("prob", "float32"), ("prob", "bfloat16"), ("fused", "float32"),
                                           ("both", "bfloat16")])
def test_encode_and_gradients_match_jax(option, dtype):
    jm, params, model, field, fh = _model_pair(OPTIONS[option], dtype)
    g = np.random.RandomState(1).randn(2, 20, 32).astype(np.float32)

    def jencode(p):
        return jm.apply(p, jnp.asarray(field), jnp.asarray(fh), method=JaxPhysicsNet.encode).astype(jnp.float32)

    # jitted, as the JAX package runs it (one compile; op by op would compile each primitive)
    want, jgrads = jax.jit(lambda p: (lambda y, vjp: (y, vjp(jnp.asarray(g))[0]))(*jax.vjp(jencode, p)))(params)
    got = model.encode(_t(field), _t(fh)).float()
    (got * _t(g)).sum().backward()
    want, got = _np(want), _np(got)
    assert got.shape == want.shape == (2, 20, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= ENCODE_SHARE_BF16 * np.abs(want).max()
    want_g = state_dict_from_jax(jgrads)
    for name, p in model.named_parameters():
        if not name.startswith("meta_net"):
            continue  # the decode's nets take no part in the encode
        w, gp = want_g[name].numpy(), p.grad.float().numpy()
        # the key projection's bias: the softmax and m = max - mean do not see it, so its exact
        # gradient is 0 and both packages hold rounding noise; held at its layer's query bias's scale
        ref = want_g[name.replace("key_projection", "query_projection")].numpy() \
            if name.endswith("key_projection.bias") else w
        scale = np.abs(ref).max()
        if dtype == "float32":
            np.testing.assert_allclose(gp, w, rtol=1e-4, atol=1e-5 * max(1.0, scale), err_msg=name)
        else:
            assert np.abs(gp - w).max() <= ENCODE_GRAD_SHARE_BF16 * scale, (name, np.abs(gp - w).max(), scale)


def test_fused_qkv_matches_the_three_projections():
    """JAX's own bar (test_models.py:105-128): fused q/k/v against the unfused encoder,
    outputs within atol 1e-5 and gradients within 1e-4, on the same parameters."""
    kw = dict(enc_in=40, c_out=16, d_model=32, n_heads=4, e_layers=2, d_ff=64, learnable_token_num=8)
    gen = torch.Generator().manual_seed(0)
    x, fh = torch.randn(2, 12, 40, generator=gen), torch.ones(2, 1)
    m0, m1 = TransformerNet(device="cpu", **kw), TransformerNet(device="cpu", fused_qkv=True, **kw)
    for p in m0.parameters():
        with torch.no_grad():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    m1.load_state_dict(m0.state_dict(), strict=True)
    assert list(m0.state_dict()) == list(m1.state_dict())
    y0, y1 = m0(x, fh), m1(x, fh)
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=0)
    (y0**2).sum().backward()
    (y1**2).sum().backward()
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        torch.testing.assert_close(b.grad, a.grad, atol=1e-4, rtol=1e-4, msg=n)


def test_train_step_with_both_options_matches_jax():
    """One training step of a model with ProbSparse attention and fused q/k/v, data-only (the
    options change the encode alone, which every step runs): the metrics at rtol 1e-4 and the
    parameters within what one Adam step can put between two runs (as
    tests/test_torch_port_train.py holds them)."""
    from tests.test_torch_port_train import COORD, FACTORS, OBS_CFG, OPT, _jax_batch, _numpy_batch

    meta = dict(META, **OPTIONS["both"])
    jspecs, tspecs = jnorm.norm_specs_from_cfg(OBS_CFG), tnorm.norm_specs_from_cfg(OBS_CFG)
    jcfg = jts.StepConfig(coord_spec=JaxCoordSpec(**COORD), obs_specs=tuple(jspecs[k] for k in jnorm.OBS_NAME_ORDER),
                          loss_factor=FACTORS)
    tcfg = tts.StepConfig(coord_spec=CoordSpec(**COORD), obs_specs=tuple(tspecs[k] for k in tnorm.OBS_NAME_ORDER),
                          loss_factor=FACTORS)
    nb = _numpy_batch()
    jbatch = _jax_batch(nb)
    jmodel = JaxPhysicsNet(meta_cfg=meta, net_cfg=NET)
    tx = j_build_optimizer(**OPT)
    params0 = _numpy_variables(jmodel.init, jbatch.field, jnp.zeros((32, 192)), jbatch.margin.nwp[0],
                               (jbatch.forecast_h / 360.0)[:, None])
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params0, opt_state=tx.init(params0))
    jstate, jmetrics = jts.make_train_step(jmodel, tx, jcfg)(jstate, jbatch, with_pde=False)

    state = tts.create_train_state(meta, NET, OPT, torch.Generator().manual_seed(0), device="cpu")
    zeros = jax.tree.map(np.zeros_like, params0)
    state = load_train_state(state, params0, zeros, zeros, 0, 0)
    state, metrics = tts.make_train_step(tcfg)(state, tts.batch_to_device(nb, device="cpu"), False)
    assert sorted(metrics) == sorted(jmetrics) and float(metrics["skipped_nonfinite"]) == 0.0
    for k, w in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4, atol=1e-12, err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    start = state_dict_from_jax(params0)
    for k, p in state.model.state_dict().items():
        diff = np.abs(p.numpy() - want[k].numpy()).max()
        assert diff <= 2 * OPT["lr"] * 1.01, (k, diff)
    assert max(float((state.model.state_dict()[k] - v).abs().max()) for k, v in start.items()) > 0.5 * OPT["lr"]


def test_every_jax_transformer_field_is_a_port_argument():
    jax_fields = {f.name for f in dataclasses.fields(JaxTransformerNet)} - {"parent", "name"}
    port_args = set(inspect.signature(TransformerNet.__init__).parameters) - {"self"}
    assert jax_fields <= port_args, jax_fields - port_args
    for option in OPTIONS.values():  # and PhysicsNet builds with each meta_cfg
        PhysicsNet(dict(META, **option), NET, device="cpu")


def test_encode_fused_refuses_a_prob_model():
    """C48: JAX's ``encode_fused`` ignores ``attn_type`` (it computes full attention for a
    prob model); the port's raises.  ``fused_qkv`` has the same parameters: it runs."""
    field, fh = torch.randn(1, 12, 65, generator=torch.Generator().manual_seed(0)), torch.tensor([[0.1]])
    with pytest.raises(ValueError, match="attn_type"):
        encode_fused(_seeded(dict(META, attn_type="prob")), field, fh)
    model = _seeded(dict(META, fused_qkv=True))
    with torch.no_grad():
        torch.testing.assert_close(encode_fused(model, field, fh), model.encode(field, fh), atol=1e-4, rtol=0)


# ---- EncoderStack and the ResNet backbones ---------------------------------------------------

def test_encoder_stack_matches_jax():
    x = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    jstack = JaxEncoderStack(d_model=16, n_heads=2, d_ff=16, e_layers=2, inp_lens=(0, 1, 2))
    params = _numpy_variables(jstack.init, jnp.asarray(x))
    stack = EncoderStack(16, 2, 16, 2, inp_lens=(0, 1, 2), device="cpu")
    stack.load_state_dict(encoder_stack_state_dict_from_jax(params), strict=True)
    got = stack(_t(x))
    assert got.shape == (2, 16 + 8 + 4, 16)
    np.testing.assert_allclose(_np(got), _np(jax.jit(jstack.apply)(params, jnp.asarray(x))), rtol=RTOL_F32,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_matches_jax(name):
    """Eval and train mode at a 32 x 32 input (NHWC in and out), and the running statistics
    after one train-mode call (flax: momentum 0.99, the biased batch variance).  In train mode
    each norm divides by its batch's spread, which carries a summation-order difference of
    the convolutions from layer to layer: 8 images, so that C5 (1 x 1) has 8 values a
    channel, and every output within RTOL_TRAIN of its endpoint's largest value (measured:
    3.9e-4 at ResNet-50's C5, 5e-6 at its C2); eval mode within RTOL_EVAL (measured 1.3e-6)."""
    keys = ("C1", "C2", "C3", "C4", "C5")
    x = np.random.RandomState(3).randn(8, 32, 32, 5).astype(np.float32)
    jnet = jbackbone.build_backbone(name, out_keys=keys)
    variables = _numpy_variables(jnet.init, jnp.asarray(x))
    net = backbone.build_backbone(name, out_keys=keys, in_channels=5)
    net.load_state_dict(resnet_state_dict_from_jax(variables, net), strict=True)
    want_eval, (want_train, updates) = jax.jit(lambda v, a: (
        jnet.apply(v, a), jnet.apply(v, a, train=True, mutable=["batch_stats"])))(variables, jnp.asarray(x))
    with torch.no_grad():
        got_eval = net(_t(x))
        got_train = net(_t(x), train=True)
    for want, got, rtol in ((want_eval, got_eval, RTOL_EVAL), (want_train, got_train, RTOL_TRAIN)):
        assert list(got) == list(keys)
        for k in keys:
            assert got[k].shape == want[k].shape, k
            w = _np(want[k])
            assert np.abs(_np(got[k]) - w).max() <= rtol * np.abs(w).max(), k
    want_stats = resnet_state_dict_from_jax(dict(variables, batch_stats=updates["batch_stats"]), net)
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            w = want_stats[k].numpy()
            assert np.abs(v.numpy() - w).max() <= RTOL_TRAIN * np.abs(w).max(), k
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


# ---- SineCosPE, normalize, the registries, flops, profiling ---------------------------------

@pytest.mark.parametrize("include_input", [False, True])
def test_sinecos_pe_class_matches_jax(include_input):
    x = np.random.RandomState(4).randn(7, 3).astype(np.float32)
    jpe = JaxSineCosPE(3, N_freqs=6, max_freq=3.0, include_input=include_input)
    tpe = SineCosPE(3, N_freqs=6, max_freq=3.0, include_input=include_input)
    assert tpe.out_dim == jpe.out_dim and tpe.n_freqs == jpe.n_freqs
    np.testing.assert_array_equal(tpe.freq_bands, jpe.freq_bands)
    np.testing.assert_allclose(_np(tpe.forward(_t(x))), _np(jpe(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


NORM_CASES = {
    "mean_norm": dict(norm_type="mean_norm", norm_factor=(283.5, 15.5)),
    "mean_norm_vector": dict(norm_type="mean_norm", norm_factor=((280.0, 270.0, 260.0), (10.0, 12.0, 14.0))),
    "min_max_1": dict(norm_type="min_max", norm_factor=100.0),
    "min_max_2": dict(norm_type="min_max", norm_factor=(250.0, 320.0)),
    "min_max_3": dict(norm_type="min_max", norm_factor=(0.5, 3.0, 1.0)),
    "unused": dict(norm_type="mean_norm", norm_factor=(1.0, 2.0), use_norm=False),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_matches_jax(case, dtype):
    x = (280.0 + 5.0 * np.random.RandomState(5).rand(4, 3)).astype(np.float32)
    spec_kw = NORM_CASES[case]
    jspec, tspec = jnorm.NormSpec(name="v", **spec_kw), tnorm.NormSpec(name="v", **spec_kw)
    want = jnorm.normalize(jnp.asarray(x, getattr(jnp, dtype)), jspec)
    got = tnorm.normalize(_t(x, getattr(torch, dtype)), tspec)
    assert str(got.dtype).split(".")[1] == str(jnp.asarray(want).dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)


def test_registries_build_the_port_modules():
    assert "PhysicsNet" in MODELS and set(BACKBONES.keys()) == set(jbackbone.BACKBONES.keys())
    model = build_model("PhysicsNet", meta_cfg=dict(META, attn_type="prob"), net_cfg=NET, device="cpu")
    assert isinstance(model, PhysicsNet)
    assert model.meta_net.model.encoder.attn_layers[0].attention.attn_type == "prob"
    net = backbone.build_backbone("resnet34", out_keys=("C3", "C4"))
    assert [len(getattr(net, f"layer{i}")) for i in range(1, 5)] == [3, 4, 6, 3]
    out = net(torch.zeros(1, 32, 32, 3))
    assert list(out) == ["C3", "C4"] and out["C4"].shape == (1, 2, 2, 256)


def test_flops_match_jax_and_no_peak_on_the_cpu():
    for kw in ({}, dict(in_ch=96, hidden=64, n_vars=3)):
        assert tflops.decode_jvp_v4_flops_per_point(**kw) == jflops.decode_jvp_v4_flops_per_point(**kw)
        assert tflops.decode_primal_v4_flops_per_point(**kw) == jflops.decode_primal_v4_flops_per_point(**kw)
    assert tflops.chip_peak_flops("cpu") is None and tflops.chip_peak_flops(torch.device("cpu")) is None
    assert tflops.mfu(1e12, 1.0, "cpu") is None
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert tflops.compiled_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4


def test_trace_writes_a_chrome_trace(tmp_path):
    meter = ThroughputMeter()
    with trace(str(tmp_path)):
        for step in range(2):
            with step_annotation("train", step):
                torch.ones(64, 64) @ torch.ones(64, 64)
            meter.update(100)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json") and os.path.getsize(tmp_path / files[0]) > 0
    assert "train#1" in (tmp_path / files[0]).read_text()
    s = meter.summary()
    assert s["points_per_sec"] > 0 and s["steps_per_sec"] > 0
    with trace(None):  # off: a no-op
        pass
