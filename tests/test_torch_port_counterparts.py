"""PyTorch port against the JAX package: the last public names with a counterpart.

``__version__``, ``native.gather`` and ``native.pack_tokens`` (on the same ``dpn_gather`` /
``dpn_pack_tokens`` symbols of ``native/src/dpn_native.cc``, and their numpy fallbacks) and the
``CrossEntropyLoss`` entry of the loss registry, each against the JAX package's on the same numpy
inputs: the cases of ``tests/test_native.py`` and seeded logits with integer and soft labels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepphysinet_tpu
from deepphysinet_tpu import native as jnative
from deepphysinet_tpu.train.losses import build_loss as j_build_loss

import deepphysinet_tpu_torch
from deepphysinet_tpu_torch import native as tnative
from deepphysinet_tpu_torch.train.losses import LOSSES, build_loss

torch.set_num_threads(1)


def test_version_matches_jax():
    from deepphysinet_tpu_torch.version import __version__

    assert deepphysinet_tpu_torch.__version__ == __version__ == deepphysinet_tpu.__version__ == "0.1.0"


@pytest.fixture(params=["library", "numpy"])
def port_native(request, monkeypatch):
    """The port's binding on its built library, and with no library (the numpy fallbacks)."""
    if request.param == "library":
        assert tnative.available(), tnative.BUILD_ERROR
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return tnative


def test_gather_matches_jax(port_native):
    rng = np.random.RandomState(0)
    img = rng.randn(9, 13).astype(np.float32)
    xs = rng.randint(0, 13, 50)
    ys = rng.randint(0, 9, 50)
    got = port_native.gather(img, xs, ys)
    np.testing.assert_array_equal(got, jnative.gather(img, xs, ys))
    np.testing.assert_array_equal(got, img[ys, xs])
    # indices past the raster clip to its edges, in both packages
    xs_out, ys_out = np.array([-3, 0, 12, 40]), np.array([2, -1, 30, 8])
    np.testing.assert_array_equal(port_native.gather(img, xs_out, ys_out), jnative.gather(img, xs_out, ys_out))


def test_pack_tokens_matches_jax(port_native):
    rng = np.random.RandomState(1)
    raster = rng.randn(7, 9, 5).astype(np.float32)
    mean = rng.randn(5).astype(np.float32)
    std = (rng.rand(5).astype(np.float32) + 0.5)
    got = port_native.pack_tokens(raster, mean, std)
    want = jnative.pack_tokens(raster, mean, std)
    assert got.shape == want.shape == (5, 63) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = ((raster.reshape(-1, 5).T - mean[:, None]) / std[:, None]).astype(np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("labels", ["integer", "soft"])
def test_cross_entropy_matches_jax(labels):
    assert "CrossEntropyLoss" in LOSSES
    rng = np.random.RandomState(2)
    logits = (rng.randn(4, 7, 10) * 3.0).astype(np.float32)
    if labels == "integer":
        y = rng.randint(0, 10, (4, 7))
    else:
        y = rng.rand(4, 7, 10).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
    got = build_loss("CrossEntropyLoss")(torch.from_numpy(logits), torch.from_numpy(y))
    want = j_build_loss("CrossEntropyLoss")(jnp.asarray(logits), jnp.asarray(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits are taken in float32, as in JAX
    got16 = build_loss("CrossEntropyLoss")(torch.from_numpy(logits).bfloat16(), torch.from_numpy(y))
    want16 = j_build_loss("CrossEntropyLoss")(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(y))
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)
