"""Port parity: SAM on the TINY config of tests/test_sam.py — the image
encoder embedding, the box-prompted decode and the predictor's state API
(compute_image_state, decode_lowres_state, masks_from_lowres) against the
JAX package, with the JAX params carried over by the bridge.

Tolerances: fp32 per model atol = rtol = 1e-3; masks (booleans after the
threshold) may differ only where a logit sits at the threshold: at most
0.1% of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.weights import SAM_RULES
from inklayer_tpu.models.sam import Sam as JaxSam
from inklayer_tpu.models.sam import SamPredictor as JaxPredictor
from inklayer_tpu_torch.models.sam import Sam, SamPredictor
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_sam import TINY

MODEL = dict(atol=1e-3, rtol=1e-3)


def random_jax_params(model, args, seed: int, std: float = 0.2):
    """Seeded N(0, std) params of the JAX model's param tree (numpy)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: model.init(k, *args), jax.random.key(0))
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
        shapes)


# the mask-prompt convnet: the port's PromptEncoder holds it (so that a
# reference checkpoint loads strictly), the JAX param tree does not
MASK_PROMPT = "prompt_encoder.mask_downscaling."


def sam_pair(cfg=TINY, seed: int = 1, std: float = 0.2):
    """(JAX Sam, its params, the bridged torch Sam).  The mask-prompt
    convnet, which no box-prompted path runs, keeps the module's own
    values."""
    jm = JaxSam(cfg)
    args = (jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
            jnp.zeros((4, 4)))
    params = random_jax_params(jm, args, seed, std)
    tm = Sam(cfg)
    sd = jax_to_torch_state_dict(flatten_tree(params["params"]), SAM_RULES)
    sd.update({k: v for k, v in tm.state_dict().items()
               if k.startswith(MASK_PROMPT)})
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    # std 0.5: masks that cover part of the image (std 0.2 fills them all)
    return sam_pair(std=0.5)


def test_encoder_embedding_matches_jax(pair, rng):
    jm, params, tm = pair
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=JaxSam.encode))(
        params, jnp.asarray(img))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(img))
    assert got.shape == (1, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def test_box_decode_matches_jax(pair, rng):
    jm, params, tm = pair
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[8.0, 8.0, 40.0, 48.0], [0.0, 0.0, 64.0, 64.0],
                        [30.0, 2.0, 33.0, 60.0]], np.float32)
    want_logits, want_iou = jax.jit(jm.apply)(params, jnp.asarray(img),
                                              jnp.asarray(boxes))
    with torch.no_grad():
        logits, iou = tm(torch.from_numpy(img), torch.from_numpy(boxes))
    assert logits.shape == (3, 1, 16, 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **MODEL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), **MODEL)


def test_predictor_state_api_matches_jax(pair, rng):
    _, params, tm = pair
    image = (rng.random((50, 30, 3)) * 255).astype(np.uint8)
    boxes = np.zeros((8, 4), np.float32)
    boxes[:5] = [[2, 2, 25, 45], [0, 0, 30, 50], [10, 5, 20, 40],
                 [1, 30, 29, 49], [5, 5, 6, 6]]
    jp = JaxPredictor(params, TINY, box_capacity=8)
    tp = SamPredictor(tm, box_capacity=8)
    js = jp.compute_image_state(image)
    ts = tp.compute_image_state(torch.from_numpy(image))
    assert ts["input_hw"] == js["input_hw"] and ts["orig_hw"] == js["orig_hw"]
    np.testing.assert_array_equal(ts["scale"], js["scale"])
    np.testing.assert_allclose(ts["embedding"].numpy(),
                               np.asarray(js["embedding"]), **MODEL)
    scaled = boxes * np.tile(js["scale"], 2)
    j_low, j_iou = jp.decode_lowres_state(js, jnp.asarray(scaled))
    t_low, t_iou = tp.decode_lowres_state(ts, torch.from_numpy(scaled))
    np.testing.assert_allclose(t_low.numpy(), np.asarray(j_low), **MODEL)
    np.testing.assert_allclose(t_iou.numpy(), np.asarray(j_iou), **MODEL)
    for n in (1, 5, 8):  # buckets 1, 8, 8
        j_masks = np.asarray(jp.masks_from_lowres(js, j_low, n))
        t_masks = tp.masks_from_lowres(ts, t_low, n).numpy()
        assert t_masks.shape == j_masks.shape == (n, 50, 30)
        assert t_masks.dtype == bool
        assert (t_masks != j_masks).mean() <= 1e-3
    assert 0.05 < t_masks.mean() < 0.95  # masks are not trivially full/empty
