"""`preprocess_on_device`'s resize (`msvit_tpu_torch/data/pipeline.py::
resize_like_jax`) against `jax.image.resize` on the CPU, f32: every method
JAX takes, up and down, on both axes at once and on one axis alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.data import pipeline as jpipe
from msvit_tpu_torch.data import pipeline as tpipe

METHODS = ["nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
           "tricubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("shape,size", [((20, 28), 40), ((40, 28), 16), ((16, 31), 16)],
                         ids=["up", "down", "one-axis"])
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method, shape, size):
    """The resized [0, 255] values within 1e-4 of that range (0.0255; the
    weights agree to f32 rounding, the sums run in another order: H, then
    W, where JAX contracts both in one einsum), and `preprocess_on_device`'s
    normalized output against JAX's within 1e-4."""
    u8 = np.random.default_rng(len(method)).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(u8, jnp.float32), (2, size, size, 3),
                                       method))
    got = tpipe.resize_like_jax(torch.from_numpy(u8).float(), (size, size), method)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * 255, rtol=0)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    norm = tpipe.preprocess_on_device(
        torch.from_numpy(u8), tpipe.ImagePipelineConfig(image_size=size, method=method))
    ref = jpipe.preprocess_on_device(
        jnp.asarray(u8), jpipe.ImagePipelineConfig(image_size=size, method=method))
    np.testing.assert_allclose(norm.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_resize_weights_of_an_unknown_method_raise():
    with pytest.raises(ValueError, match="resize method"):
        tpipe.preprocess_on_device(torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
                                   tpipe.ImagePipelineConfig(image_size=4, method="area"))
