"""Port parity: GroundingDINO on the TINY config of tests/test_gdino.py —
the model's logits and boxes against GroundingDINO.apply, and
GDinoDetector.detect (top-K, threshold, period-stripped labels) against
the JAX detector, with the JAX params carried over by the bridge.

Tolerances: fp32 per model atol = rtol = 1e-3; -inf logits (padded text
positions) must sit at the same places; labels must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.weights import GDINO_RULES
from inklayer_tpu.models.gdino import GDinoDetector as JaxDetector
from inklayer_tpu.models.gdino import GroundingDINO as JaxGDINO
from inklayer_tpu.models.gdino import subsentence_masks
from inklayer_tpu_torch.models.gdino import GDinoDetector, GroundingDINO
from inklayer_tpu_torch.models.gdino.bert import \
    subsentence_masks as t_subsentence_masks
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_gdino import TINY
from tests.test_torch_sam import random_jax_params

MODEL = dict(atol=1e-3, rtol=1e-3)
IDS = np.asarray([[101, 4874, 1012, 102]])  # "object."


def gdino_pair(cfg=TINY, seed: int = 2):
    """(JAX GroundingDINO, its params, the bridged torch model)."""
    jm = JaxGDINO(cfg)
    attn, pos = subsentence_masks(IDS)
    bucket = cfg.shape_buckets[0]
    args = (jnp.zeros((1,) + bucket + (3,)), jnp.zeros((1,) + bucket, bool),
            jnp.asarray(IDS, jnp.int32), jnp.asarray(attn),
            jnp.asarray(pos.astype(np.int32)))
    params = random_jax_params(jm, args, seed)
    tm = GroundingDINO(cfg)
    tm.load_state_dict(jax_to_torch_state_dict(flatten_tree(params["params"]),
                                               GDINO_RULES), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return gdino_pair()


def test_subsentence_masks_match_jax():
    ids = np.asarray([[101, 5, 6, 1012, 7, 1029, 8, 9, 102, 0]])
    for a, b in zip(t_subsentence_masks(ids), subsentence_masks(ids)):
        np.testing.assert_array_equal(a, b)


def test_model_logits_and_boxes_match_jax(pair, rng):
    jm, params, tm = pair
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((1, 64, 64), bool)
    pad[:, 50:, :] = True  # a padded bucket: masks, valid ratios, proposals
    attn, pos = subsentence_masks(IDS)
    # jitted: eager flax dispatch of this graph takes ~20 s on the CPU
    want_logits, want_boxes = jax.jit(jm.apply)(
        params, jnp.asarray(img), jnp.asarray(pad), jnp.asarray(IDS, jnp.int32),
        jnp.asarray(attn), jnp.asarray(pos.astype(np.int32)))
    with torch.no_grad():
        logits, boxes = tm(torch.from_numpy(img), torch.from_numpy(pad),
                           torch.from_numpy(IDS), torch.from_numpy(attn),
                           torch.from_numpy(pos))
    want_logits = np.asarray(want_logits)
    finite = np.isfinite(want_logits)
    np.testing.assert_array_equal(np.isfinite(logits.numpy()), finite)
    np.testing.assert_allclose(logits.numpy()[finite], want_logits[finite],
                               **MODEL)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), **MODEL)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_detector_matches_jax(pair, rng, threshold):
    _, params, tm = pair
    image = (rng.random((90, 120, 3)) * 255).astype(np.uint8)
    want = JaxDetector(params, TINY).detect(image, box_threshold=threshold)
    got = GDinoDetector(tm).detect(torch.from_numpy(image),
                                   box_threshold=threshold)
    assert got["caption"] == want["caption"] == "object."
    np.testing.assert_allclose(got["scores"], want["scores"], **MODEL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], **MODEL)
    np.testing.assert_allclose(got["token_logits"], want["token_logits"],
                               **MODEL)
    assert got["labels"] == want["labels"]
    assert all("." not in label for label in got["labels"])


def test_positive_map_matches_jax():
    from inklayer_tpu.models.gdino.tokenizer import WordPieceTokenizer as JT
    from inklayer_tpu.models.gdino.vl_utils import create_positive_map as jcpm
    from inklayer_tpu_torch.models.gdino.tokenizer import WordPieceTokenizer
    from inklayer_tpu_torch.models.gdino.vl_utils import create_positive_map

    caption = "a cat. two dogs on the table."
    spans = [(2, 5), (7, 15), (23, 28)]
    np.testing.assert_array_equal(
        create_positive_map(WordPieceTokenizer(), caption, spans, 16),
        jcpm(JT(), caption, spans, 16))


def test_fusion_max_is_detached_like_jax():
    """BiMultiHeadAttention subtracts its logits' global max and each text
    row's max, then clamps at +/-50k; the JAX package stops both maxima's
    gradients.  One head of width 2 with identity projections puts the
    global max at q0.k0 = 1e5 and row 1 at 50005 / 49995, one entry 5
    inside the clamp and one 5 outside: there the gradient through an
    undetached max is not a rounding term (it moves the gradient of v0
    and l0, the argmax logit's inputs, by ~10%), and those gradients must
    be the JAX ones, within 5e-3 (fp32: row 1's terms nearly cancel, and
    the fp64 value lies between the two packages' fp32 ones; v1's own
    gradient is left out, as fp32 leaves it ~7% apart).  An undetached
    max is 4% off for l0 and 11% for v0."""
    from inklayer_tpu.models.gdino.fusion import BiMultiHeadAttention as JBi
    from inklayer_tpu_torch.models.gdino.fusion import BiMultiHeadAttention

    a0, b0 = 400.0, 250.0
    a1 = 50005.0 / b0
    q = np.asarray([[a0, 0.0], [a1, 0.0], [3.0, -2.0]], np.float32)
    v = q * np.float32(2 ** 0.5)  # v_proj is the identity: q = v / sqrt(2)
    l = np.asarray([[b0, 0.0], [49995.0 / a1, 0.0]], np.float32)
    eye, zero = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
    names = ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
             "out_v_proj", "out_l_proj")
    jm = JBi(v_dim=2, l_dim=2, embed_dim=2, num_heads=1)
    params = {"params": {n: {"kernel": jnp.asarray(eye),
                             "bias": jnp.asarray(zero)} for n in names}}
    tm = BiMultiHeadAttention(2, 2, 2, 1)
    with torch.no_grad():
        for n in names:
            getattr(tm, n).weight.copy_(torch.eye(2))
            getattr(tm, n).bias.zero_()
    rng = np.random.default_rng(1)
    rv = rng.standard_normal((1, 3, 2)).astype(np.float32)
    rl = rng.standard_normal((1, 2, 2)).astype(np.float32)

    def jloss(v_, l_):
        dv, dl = jm.apply(params, v_, l_)
        return jnp.sum(dv * rv) + jnp.sum(dl * rl)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v[None]),
                                           jnp.asarray(l[None]))
    tv = torch.tensor(v[None], requires_grad=True)
    tl = torch.tensor(l[None], requires_grad=True)
    dv, dl = tm(tv, tl)
    (torch.sum(dv * torch.from_numpy(rv))
     + torch.sum(dl * torch.from_numpy(rl))).backward()
    for got, w in ((tv.grad, want[0]), (tl.grad, want[1])):
        w = np.asarray(w)[0, 0]
        assert np.abs(w).min() > 0.1
        np.testing.assert_allclose(got[0, 0].numpy(), w, rtol=5e-3)
