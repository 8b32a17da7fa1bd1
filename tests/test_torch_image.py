"""Port parity: image preprocessing (inklayer_tpu_torch.ops.image) against
jax.image as the JAX package uses it: the 1-D resize matrices (half-pixel
centres, antialias widening on downscale) and scale_pad_normalize for up-
and down-scales.

Tolerances: resize matrices atol 1e-6; normalised images (values ~ +-3)
atol = rtol = 1e-4 (fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.ops import image as J
from inklayer_tpu_torch.ops import image as T


@pytest.mark.parametrize("n_in,n_out", [(256, 1024), (1024, 750), (1000, 96),
                                        (64, 64), (17, 5)])
def test_resize_matrix_matches_jax(n_in, n_out):
    np.testing.assert_allclose(T.resize_matrix(n_in, n_out),
                               J.resize_matrix(n_in, n_out), atol=1e-6)


def test_resize_batch_matches_jax_resize(rng):
    x = rng.standard_normal((3, 40, 24)).astype(np.float32)
    want = J.resize(jnp.asarray(x.transpose(1, 2, 0)), (100, 13))
    got = T.resize_batch(torch.from_numpy(x), (100, 13))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(2, 0, 1),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw,out_hw,mode", [((50, 30), (64, 64), "longest"),
                                            ((750, 750), (1024, 1024), "longest"),
                                            ((300, 200), (128, 128), "longest"),
                                            ((128, 96), (800, 1066), "shortest"),
                                            ((900, 1400), (800, 1344), "shortest")])
def test_scale_pad_normalize_matches_jax(rng, hw, out_hw, mode):
    h, w = hw
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    s = T.resize_scale(hw, out_hw, mode)
    assert s == J.resize_scale(hw, out_hw, mode)
    if mode == "longest":  # SAM: per-axis scales to the rounded size
        nh, nw = int(h * s + 0.5), int(w * s + 0.5)
        scale = (np.float32(nh / h), np.float32(nw / w))
        j_scale = jnp.asarray([nh / h, nw / w], jnp.float32)
    else:  # GDINO: one scale, capped to the bucket
        s = min(s, min(out_hw[0] / h, out_hw[1] / w))
        scale = (np.float32(s), np.float32(s))
        j_scale = jnp.float32(s)
    want = J.scale_pad_normalize(jnp.asarray(img), j_scale, mean, std, out_hw)
    got = T.scale_pad_normalize(torch.from_numpy(img), scale, mean, std, out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_pick_bucket_matches_jax():
    buckets = ((800, 800), (800, 1066), (800, 1344), (1066, 800), (1344, 800))
    for h, w in ((750, 750), (600, 900), (400, 1300), (1300, 500), (90, 70)):
        assert T.pick_bucket(h, w, buckets) == J.pick_bucket(h, w, buckets)
