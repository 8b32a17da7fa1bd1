"""Port parity: Depth-Anything-V2 on the TINY config of tests/test_depth.py
(DINOv2 + DPT through the parameter bridge) and the resampling it uses,
against the JAX package on the CPU.

Tolerances: the resize ops 1e-5 absolute on inputs in [0, 1] (same
float32 weight matrices, a different summation order); the model 1e-4
relative (L2) in fp32; the quantized depth map within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.weights import DEPTH_RULES
from inklayer_tpu.models.depth import DepthAnythingV2 as JaxDepth
from inklayer_tpu.models.depth import DepthEstimator as JaxEstimator
from inklayer_tpu.ops import image as J
from inklayer_tpu_torch.models.depth import (DepthAnythingV2, DepthEstimator,
                                             depth_bucket)
from inklayer_tpu_torch.models.depth.dpt import quantize_depth
from inklayer_tpu_torch.ops import image as T
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_depth import TINY
from tests.test_torch_sam import random_jax_params


def depth_pair(cfg=TINY, seed: int = 2, std: float = 0.2):
    """(JAX DepthAnythingV2, its params, the bridged torch model)."""
    jm = JaxDepth(cfg)
    args = (jnp.zeros((1, cfg.input_size, cfg.input_size, 3)),)
    params = random_jax_params(jm, args, seed, std)
    tm = DepthAnythingV2(cfg)
    tm.load_state_dict(jax_to_torch_state_dict(flatten_tree(params["params"]),
                                               DEPTH_RULES), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return depth_pair()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("shape,out", [((75, 60, 3), (56, 70)),
                                       ((20, 30, 3), (41, 33)),
                                       ((37, 37, 8), (40, 50)),
                                       ((750, 750, 3), (518, 518))])
def test_bicubic_antialias_resize_matches_jax(rng, shape, out):
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(J.resize(jnp.asarray(x), out, "bicubic",
                               antialias=True))
    got = T.resize(torch.from_numpy(x), out, "bicubic").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,out", [((1, 7, 9, 4), (28, 36)),
                                       ((2, 37, 37, 3), (750, 750)),
                                       ((1, 5, 6, 2), (5, 6))])
def test_align_corners_resize_matches_jax(rng, shape, out):
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(J.resize_align_corners(jnp.asarray(x), out))
    got = T.resize_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bridged_depth_params_load_strict(pair):
    _, params, tm = pair
    flat = flatten_tree(params["params"])
    assert sum(v.size for v in flat.values()) == sum(
        p.numel() for p in tm.state_dict().values())


def test_full_vitb_tree_maps_every_key():
    """Every param of the full ViT-B tree has a checkpoint key in the port's
    module with the shape the bridge produces (shapes from
    jax.eval_shape; no arrays)."""
    from inklayer_tpu.config import DepthConfig as JaxDepthConfig
    from inklayer_tpu_torch.config import DepthConfig

    jm = JaxDepth(JaxDepthConfig())
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 518, 518, 3))),
                            jax.random.key(0))
    zeros = flatten_tree(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
    assert len(zeros) > 150
    got = jax_to_torch_state_dict(zeros, DEPTH_RULES)
    want = DepthAnythingV2(DepthConfig()).state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.shape == want[key].shape, key


@pytest.mark.parametrize("hw", [(56, 56), (56, 70)])
def test_tiny_depth_model_matches_jax(pair, rng, hw):
    """(56, 70) interpolates the position embedding (bicubic)."""
    jm, params, tm = pair
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *hw)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-4


def test_depth_estimator_and_quantized_map_match_jax(pair, rng):
    _, params, tm = pair
    image = (rng.random((100, 130, 3)) * 255).astype(np.uint8)
    want = np.asarray(JaxEstimator(params, TINY).infer_image(image))
    got = DepthEstimator(tm).infer_image_device(torch.from_numpy(image))
    assert got.shape == (100, 130)
    assert _rel(got.numpy(), want) <= 1e-4
    from inklayer_tpu.pipeline.runner import _quantize_depth

    want_u8 = np.asarray(_quantize_depth(jnp.asarray(want)))
    got_u8 = quantize_depth(got).numpy()
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(750, 750), (480, 640), (1333, 800)])
def test_depth_bucket_matches_jax(hw):
    from inklayer_tpu.config import DepthConfig as JaxDepthConfig
    from inklayer_tpu.models.depth import depth_bucket as jax_bucket
    from inklayer_tpu_torch.config import DepthConfig

    assert depth_bucket(*hw, DepthConfig()) == jax_bucket(*hw,
                                                          JaxDepthConfig())
