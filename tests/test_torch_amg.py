"""Port parity: the automatic mask generator
(``inklayer_tpu_torch.models.sam.amg``) against the JAX package's
``inklayer_tpu.models.sam.amg``.

* the helpers on seeded inputs: point grids, crop boxes and the crop-edge
  test exactly, stability scores and mask boxes exactly, box NMS the same
  indices, the RLE round trip and the same RLE as the JAX package;
* ``generate`` on the TINY SAM of tests/test_sam.py with the same params
  (bridged) on a seeded 50 x 40 image, at crop_n_layers 0 and 1: the same
  records in the same order, equal segmentations, RLEs, boxes, crop boxes
  and point coordinates, predicted IoU and stability within 1e-4 (fp32 on
  both sides; the port keeps the survivors' logits on the device, the JAX
  package reads them back and uploads them again: the same arithmetic);
* ``generate`` with thresholds set between observed scores: no score of
  the run lies within 0.5 of the predicted-IoU threshold or within 0.02
  of the stability threshold, so a 1e-4 difference cannot move a record
  across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.models.sam import SamPredictor as JaxPredictor
from inklayer_tpu.models.sam import amg as J
from inklayer_tpu_torch.models.sam import SamPredictor
from inklayer_tpu_torch.models.sam import amg as T
from tests.test_sam import TINY
from tests.test_torch_sam import sam_pair

SCORES = dict(atol=1e-4, rtol=1e-4)


def test_point_grids_and_crop_boxes_match_jax():
    for n in (1, 4, 7, 32):
        np.testing.assert_array_equal(T.build_point_grid(n),
                                      J.build_point_grid(n))
    for args in ((16, 1, 1), (32, 2, 2), (9, 1, 2)):
        for a, b in zip(T.build_all_layer_point_grids(*args),
                        J.build_all_layer_point_grids(*args)):
            np.testing.assert_array_equal(a, b)
    for size, layers in (((750, 750), 1), ((50, 40), 2), ((480, 640), 1)):
        assert T.generate_crop_boxes(size, layers, 512 / 1500) == \
            J.generate_crop_boxes(size, layers, 512 / 1500)


def test_box_helpers_match_jax(rng):
    boxes = rng.integers(0, 60, (40, 4)).astype(np.float64)
    boxes[:, 2:] += boxes[:, :2]
    crop = [10, 5, 50, 45]
    np.testing.assert_array_equal(
        T.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 70]),
        J.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 70]))
    scores = rng.random(40)
    scores[5] = scores[6]  # a tie
    for thr in (0.0, 0.3, 0.7):
        np.testing.assert_array_equal(T.box_nms(boxes, scores, thr),
                                      J.box_nms(boxes, scores, thr))


def test_stability_and_mask_boxes_match_jax(rng):
    logits = (rng.standard_normal((5, 3, 16, 16)) * 3).astype(np.float32)
    logits[0, 0] = -5.0  # nothing above either threshold
    np.testing.assert_array_equal(
        T.stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy(),
        np.asarray(J.stability_score(jnp.asarray(logits), 0.0, 1.0)))
    masks = rng.random((6, 13, 17)) > 0.97
    masks[0] = False
    masks[1] = True
    got = T.mask_boxes(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        J.mask_boxes(jnp.asarray(masks))))
    assert got[0].tolist() == [0, 0, 0, 0] and got[1].tolist() == [0, 0, 17,
                                                                     13]


@pytest.mark.parametrize("shape", [(13, 17), (8, 8), (1, 9)])
def test_rle_round_trip_matches_jax(rng, shape):
    for p in (0.0, 0.4, 1.0):
        m = rng.random(shape) < p
        rle = T.mask_to_rle(m)
        assert rle == J.mask_to_rle(m)
        np.testing.assert_array_equal(T.rle_to_mask(rle), m)


@pytest.fixture(scope="module")
def generators():
    """(JAX, port) generator factories over the same TINY SAM params, and
    the seeded image."""
    _, params, tm = sam_pair(TINY, std=0.5)
    image = (np.random.default_rng(11).random((50, 40, 3)) * 255).astype(
        np.uint8)

    def make(**kw):
        return (J.SamAutomaticMaskGenerator(
                    JaxPredictor(params, TINY, box_capacity=8), **kw),
                T.SamAutomaticMaskGenerator(
                    SamPredictor(tm, box_capacity=8), **kw))

    return make, image


def _assert_same_records(got, want):
    assert len(got) == len(want)
    keys = {"segmentation", "rle", "area", "bbox", "bbox_xyxy", "crop_box",
            "predicted_iou", "stability_score", "point_coords"}
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        for k in ("rle", "area", "bbox", "bbox_xyxy", "crop_box",
                  "point_coords"):
            assert g[k] == w[k], k
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(g[k], w[k], **SCORES)


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_generate_matches_jax(generators, crop_n_layers):
    """Every survivor kept (thresholds open): the decode, upsampling, edge
    filter, both NMS passes and the records."""
    make, image = generators
    jax_amg, amg = make(points_per_side=4, points_per_batch=8,
                        pred_iou_thresh=-np.inf, stability_score_thresh=0.0,
                        crop_n_layers=crop_n_layers)
    want, got = jax_amg.generate(image), amg.generate(image)
    _assert_same_records(got, want)
    assert len(got) > 0 and any(r["area"] > 0 for r in got)
    assert amg.last_survivors == 16 * 3 * (1 + 4 * crop_n_layers)
    for r in got:
        assert r["segmentation"].shape == (50, 40)
        np.testing.assert_array_equal(T.rle_to_mask(r["rle"]),
                                      r["segmentation"])


def test_generate_with_thresholds_matches_jax(generators):
    """Thresholds between observed scores: the filters drop some records
    and keep others, identically."""
    make, image = generators
    _, probe = make(points_per_side=4, points_per_batch=8,
                    pred_iou_thresh=-np.inf, stability_score_thresh=0.0,
                    box_nms_thresh=1.0)
    recs = probe.generate(image)
    ious = np.asarray([r["predicted_iou"] for r in recs])
    stab = np.asarray([r["stability_score"] for r in recs])
    iou_t, stab_t = -16.0, 0.71
    assert np.abs(ious - iou_t).min() > 0.5
    assert np.abs(stab - stab_t).min() > 0.02
    assert (ious > iou_t).any() and (ious < iou_t).any()
    jax_amg, amg = make(points_per_side=4, points_per_batch=8,
                        pred_iou_thresh=iou_t, stability_score_thresh=stab_t)
    want, got = jax_amg.generate(image), amg.generate(image)
    _assert_same_records(got, want)
    assert 0 < amg.last_survivors < 48
