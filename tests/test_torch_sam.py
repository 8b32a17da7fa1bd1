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


# ---------------------------------------------------------------------------
# point and mask prompts, multimask decode, the predictor's host entries
# ---------------------------------------------------------------------------

from inklayer_tpu.models.sam.prompt_encoder import PromptEncoder as JaxPE
from inklayer_tpu_torch.models.sam.prompt_encoder import PromptEncoder

# 2 prompts: points (2, 3) with every label, boxes, low-res masks at 4G
PE_ARGS = dict(embed_dim=32, image_embedding_size=(4, 4),
               input_image_size=(64, 64))


@pytest.fixture(scope="module")
def pe_pair():
    """The JAX PromptEncoder initialised with every prompt type (so the
    mask convnet's params exist) and the port's with them bridged."""
    rng = np.random.default_rng(3)
    jpe = JaxPE(**PE_ARGS)
    args = dict(points=(jnp.zeros((2, 3, 2)), jnp.zeros((2, 3), jnp.int32)),
                boxes=jnp.zeros((2, 4)), masks=jnp.zeros((2, 16, 16, 1)))
    shapes = jax.eval_shape(lambda k: jpe.init(k, **args), jax.random.key(0))
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        shapes)
    flat = {f"prompt_encoder/{k}": v
            for k, v in flatten_tree(params["params"]).items()}
    sd = jax_to_torch_state_dict(flat, SAM_RULES)
    tpe = PromptEncoder(**PE_ARGS)
    tpe.load_state_dict({k[len("prompt_encoder."):]: v
                         for k, v in sd.items()}, strict=True)
    return jpe, params, tpe.eval()


def _prompts(rng):
    pts = rng.random((2, 3, 2)).astype(np.float32) * 64
    labels = np.asarray([[1, 0, -1], [0, 1, 1]], np.int32)
    boxes = np.asarray([[4, 6, 40, 50], [10, 0, 63, 30]], np.float32)
    masks = rng.standard_normal((2, 16, 16, 1)).astype(np.float32) * 3
    return pts, labels, boxes, masks


@pytest.mark.parametrize("which", ["points", "boxes", "masks",
                                   "points+boxes", "points+masks",
                                   "points+boxes+masks"])
def test_prompt_encoder_matches_jax(pe_pair, rng, which):
    """forward with each combination of prompts (the sparse concatenation
    order: points, then boxes); embed_points with pad, negative and
    positive labels; embed_masks through the NHWC convnet; no_mask_dense
    where no mask is given.  fp32, atol = rtol = 1e-5 (one LayerNorm and
    two GELUs more than the box path)."""
    jpe, params, tpe = pe_pair
    pts, labels, boxes, masks = _prompts(rng)
    jkw, tkw = {}, {}
    if "points" in which:
        jkw["points"] = (jnp.asarray(pts), jnp.asarray(labels))
        tkw["points"] = (torch.from_numpy(pts),
                         torch.from_numpy(labels.astype(np.int64)))
    if "boxes" in which:
        jkw["boxes"], tkw["boxes"] = jnp.asarray(boxes), torch.from_numpy(boxes)
    if "masks" in which:
        jkw["masks"], tkw["masks"] = jnp.asarray(masks), torch.from_numpy(masks)
    j_sparse, j_dense = jpe.apply(params, **jkw)
    with torch.inference_mode():
        t_sparse, t_dense = tpe(**tkw)
    if which == "masks":
        # no sparse prompt: the JAX package gives batch 1, the port the
        # masks' batch, so that the decoder's batches agree
        assert j_sparse.shape == (1, 0, 32)
        assert tuple(t_sparse.shape) == (2, 0, 32)
    else:
        assert tuple(t_sparse.shape) == j_sparse.shape
        np.testing.assert_allclose(t_sparse.numpy(), np.asarray(j_sparse),
                                   atol=1e-5, rtol=1e-5)
    assert tuple(t_dense.shape) == j_dense.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(t_dense.detach().numpy(), np.asarray(j_dense),
                               atol=1e-5, rtol=1e-5)


def test_embed_points_masks_and_no_mask_dense_match_jax(pe_pair, rng):
    jpe, params, tpe = pe_pair
    pts, labels, _, masks = _prompts(rng)
    want = jpe.apply(params, jnp.asarray(pts), jnp.asarray(labels),
                     method=JaxPE.embed_points)
    want_m = jpe.apply(params, jnp.asarray(masks), method=JaxPE.embed_masks)
    want_d = jpe.apply(params, 3, method=JaxPE.no_mask_dense)
    with torch.inference_mode():
        got = tpe.embed_points(torch.from_numpy(pts),
                               torch.from_numpy(labels.astype(np.int64)))
        got_m = tpe.embed_masks(torch.from_numpy(masks))
        got_d = tpe.no_mask_dense(3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(got_d.detach().numpy(), np.asarray(want_d))
    # a pad point carries only not_a_point_embed
    np.testing.assert_allclose(got[0, 2].numpy(),
                               tpe.not_a_point_embed.weight[0].detach().numpy())


@pytest.mark.parametrize("multimask", [False, True])
def test_box_decode_multimask_matches_jax(pair, rng, multimask):
    """Sam.decode_boxes with and without multimask_output: (N, 3, ...)
    masks and iou are the decoder's tokens 1-3 (tolerance MODEL)."""
    jm, params, tm = pair
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[8.0, 8.0, 40.0, 48.0], [30.0, 2.0, 33.0, 60.0]],
                       np.float32)
    emb = jax.jit(lambda p, x: jm.apply(p, x, method=JaxSam.encode))(
        params, jnp.asarray(img))
    want_l, want_i = jm.apply(params, emb, jnp.asarray(boxes), multimask,
                              method=JaxSam.decode_boxes)
    with torch.inference_mode():
        got_l, got_i = tm.decode_boxes(torch.from_numpy(np.array(emb)),
                                       torch.from_numpy(boxes), multimask)
    m = 3 if multimask else 1
    assert tuple(got_l.shape) == (2, m, 16, 16)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **MODEL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **MODEL)


@pytest.fixture(scope="module")
def predictors(pair):
    """The JAX and the port's predictors with set_image on one image."""
    _, params, tm = pair
    image = (np.random.default_rng(5).random((50, 30, 3)) * 255).astype(
        np.uint8)
    jp = JaxPredictor(params, TINY, box_capacity=4)
    tp = SamPredictor(tm, box_capacity=4)
    jp.set_image(image)
    tp.set_image(image)
    return jp, tp


BOXES = np.asarray([[2, 2, 25, 45], [0, 0, 30, 50], [10, 5, 20, 40]],
                   np.float32)


def test_set_image_matches_jax(predictors):
    jp, tp = predictors
    assert tp.state["input_hw"] == jp._input_hw
    assert tp.state["orig_hw"] == jp._orig_hw
    np.testing.assert_array_equal(tp.state["scale"], jp._scale)
    np.testing.assert_allclose(tp.state["embedding"].numpy(),
                               np.asarray(jp._embedding), **MODEL)


@pytest.mark.parametrize("entry", ["predict_boxes", "predict_boxes_logits",
                                   "predict"])
def test_predictor_host_entries_match_jax(predictors, entry):
    """predict_boxes (masks or logits), predict: masks may differ only at
    the threshold (<= 0.1% of pixels), logits, iou and low-res logits
    within MODEL."""
    jp, tp = predictors
    if entry == "predict":
        want, got = jp.predict(BOXES), tp.predict(BOXES)
    else:
        rl = entry.endswith("logits")
        want = jp.predict_boxes(BOXES, return_logits=rl)
        got = tp.predict_boxes(BOXES, return_logits=rl)
    assert got[0].shape == want[0].shape == (3, 50, 30)
    if got[0].dtype == bool:
        assert (got[0] != want[0]).mean() <= 1e-3
        assert 0.02 < got[0].mean() < 0.98
    else:
        np.testing.assert_allclose(got[0], want[0], **MODEL)
    np.testing.assert_allclose(got[1], want[1], **MODEL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **MODEL)


def test_predict_device_and_postprocess_match_jax(predictors):
    jp, tp = predictors
    j_masks, j_iou = jp.predict_device(BOXES)
    t_masks, t_iou = tp.predict_device(BOXES)
    assert t_masks.shape == (3, 50, 30)
    assert (t_masks.numpy() != np.asarray(j_masks)).mean() <= 1e-3
    np.testing.assert_allclose(t_iou, j_iou, **MODEL)
    low = np.random.default_rng(6).standard_normal((2, 16, 16)).astype(
        np.float32)
    np.testing.assert_allclose(tp._postprocess(torch.from_numpy(low)),
                               jp._postprocess(jnp.asarray(low)), atol=1e-5,
                               rtol=1e-5)


def test_point_prompts_and_multimask_match_jax_decode(predictors, pair):
    """predict with points (no box: the reference's pad point is added) and
    multimask_output -> (N, 3, H, W) masks and (N, 3) iou, against the JAX
    Sam's prompt encoder and decoder on the same model-space points; then a
    mask-prompt decode from the first call's low-res logits."""
    jp, tp = predictors
    jm, params, _ = pair
    coords = np.asarray([[[5, 10]], [[20, 30]]], np.float32)
    labels = np.ones((2, 1), np.int64)
    masks, iou, low = tp.predict(point_coords=coords, point_labels=labels,
                                 multimask_output=True)
    assert masks.shape == (2, 3, 50, 30) and masks.dtype == bool
    assert iou.shape == (2, 3) and low.shape == (2, 3, 16, 16)
    pts = np.concatenate([coords * jp._scale, np.zeros((2, 1, 2))], 1)
    lab = np.concatenate([labels, -np.ones((2, 1), np.int64)], 1)

    def decode(m, emb, p, lb, mk):
        sparse, dense = m.prompt_encoder(points=(p, lb), masks=mk)
        emb = jnp.broadcast_to(emb, (p.shape[0],) + emb.shape[1:])
        return m.mask_decoder(emb, m.prompt_encoder.get_dense_pe(), sparse,
                              dense, True)

    want_low, want_iou = jm.apply(params, jp._embedding, jnp.asarray(pts),
                                  jnp.asarray(lab), None, method=decode)
    np.testing.assert_allclose(low, np.asarray(want_low), **MODEL)
    np.testing.assert_allclose(iou, np.asarray(want_iou), **MODEL)
    # a mask prompt: the first call's best low-res logits
    m2, iou2, low2 = tp.predict(point_coords=coords, point_labels=labels,
                                mask_input=low[:, 0])
    assert m2.shape == (2, 50, 30) and np.isfinite(iou2).all()
    assert np.isfinite(low2).all()
