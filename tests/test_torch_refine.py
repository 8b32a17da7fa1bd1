"""Port parity: the refine half of the default run (morphology, mask
cleaning, sketch NMS, depth sort, the NMS + depth-stat front, distance
fields and the refiner stages) against the JAX package on the CPU.

Inputs are a small deterministic sketch and mask stack made with numpy.
Boolean and integer outputs must be equal exactly; float outputs within
atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.config import RefineConfig as JaxRefineConfig
from inklayer_tpu.ops import distance as JD
from inklayer_tpu.ops import morphology as JM
from inklayer_tpu.pipeline.refine import depth_sort as JS
from inklayer_tpu.pipeline.refine import front as JF
from inklayer_tpu.pipeline.refine import mask_cleaner as JC
from inklayer_tpu.pipeline.refine import nms as JN
from inklayer_tpu.pipeline.refine import refiner as JR
from inklayer_tpu_torch.config import RefineConfig
from inklayer_tpu_torch.ops import distance as TD
from inklayer_tpu_torch.ops import morphology as TM
from inklayer_tpu_torch.pipeline.refine import depth_sort as TS
from inklayer_tpu_torch.pipeline.refine import front as TF
from inklayer_tpu_torch.pipeline.refine import mask_cleaner as TC
from inklayer_tpu_torch.pipeline.refine import nms as TN
from inklayer_tpu_torch.pipeline.refine import refiner as TR

H, W = 96, 112
CFG = RefineConfig(min_cc_area=20)
JCFG = JaxRefineConfig(min_cc_area=20)
FLOAT = dict(atol=1e-5, rtol=0)


def _gray() -> np.ndarray:
    """Strokes: two boxes, a shaded blob, a diagonal, a lone dot."""
    g = np.full((H, W), 255, np.uint8)
    g[8:50, 8:11] = 0
    g[8:50, 45:48] = 0
    g[8:11, 8:48] = 0
    g[47:50, 8:48] = 0
    g[30:80, 60:63] = 30
    g[30:80, 95:98] = 30
    g[30:33, 60:98] = 30
    g[77:80, 60:98] = 30
    g[60:75, 15:35] = 120
    for i in range(40):
        g[55 + i // 3, 20 + i] = 60
    g[90, 5] = 10
    return g


def _masks(rng) -> np.ndarray:
    """Ten masks: rectangles around the strokes, blobs with holes and
    specks, overlapping one another."""
    m = np.zeros((10, H, W), bool)
    m[0, 5:53, 5:51] = True
    m[1, 27:83, 57:101] = True
    m[2, 57:78, 12:38] = True
    m[3, 50:72, 18:62] = True
    m[4, 5:53, 5:30] = True
    m[5, 0:96, 0:112] = True
    m[6, 28:84, 56:102] = True
    m[6, 40:50, 70:80] = False          # a hole
    m[7] = rng.random((H, W)) < 0.01    # specks (<= 128 components)
    m[7, 10:30, 60:90] = True
    m[8, 6:12, 6:100] = True            # a thin bar
    m[9, 85:95, 2:9] = True
    return m


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    gray = _gray()
    masks = _masks(rng)
    depth = rng.random((H, W)).astype(np.float32) * 3.0
    boxes = np.asarray([[5, 5, 51, 53], [57, 27, 101, 83], [12, 57, 38, 78],
                        [18, 50, 62, 72], [5, 5, 30, 53], [0, 0, 111, 95],
                        [56, 28, 102, 84], [60, 10, 90, 30], [6, 6, 100, 12],
                        [2, 85, 9, 95]], float)
    scores = rng.random(10)
    return gray, masks, depth, boxes, scores


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# morphology and cleaning
# --------------------------------------------------------------------------

SES = {"rect3": JM.rect_kernel(3), "rect9": JM.rect_kernel(9),
       "ellipse3": JM.ellipse_kernel(3), "ellipse7": JM.ellipse_kernel(7),
       "disk2": JM.disk_kernel(2), "disk3": JM.disk_kernel(3)}


@pytest.mark.parametrize("se", sorted(SES))
@pytest.mark.parametrize("op", ["binary_dilate", "binary_erode",
                                "morph_close", "morph_open"])
def test_morphology_matches_jax(data, op, se):
    masks = data[1]
    want = np.asarray(getattr(JM, op)(jnp.asarray(masks), SES[se]))
    got = getattr(TM, op)(_t(masks), SES[se]).numpy()
    np.testing.assert_array_equal(got, want)


def test_structuring_elements_and_neighbor_count_match_jax(data):
    for k in (3, 5, 7, 19):
        np.testing.assert_array_equal(TM.ellipse_kernel(k),
                                      JM.ellipse_kernel(k))
    for r in (1, 2, 3):
        np.testing.assert_array_equal(TM.disk_kernel(r), JM.disk_kernel(r))
    masks = data[1]
    np.testing.assert_array_equal(
        TM.neighbor_count(_t(masks), 3).numpy(),
        np.asarray(JM.neighbor_count(jnp.asarray(masks), 3)))


@pytest.mark.parametrize("k", [3, 5, 9])
def test_clean_masks_matches_jax(data, k):
    masks = data[1]
    want, capped = JC.clean_masks(jnp.asarray(masks), k, 20, 1.1,
                                  with_stats=True)
    assert not np.asarray(capped).any()
    got, got_capped = TC.clean_masks(_t(masks), k, 20, 1.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got_capped.any()


def test_clean_masks_device_and_kernel_size_match_jax(data):
    masks = data[1]
    assert TC.kernel_size((750, 750)) == JC.kernel_size((750, 750)) == 19
    assert TC.kernel_size((H, W)) == JC.kernel_size((H, W))
    want = np.asarray(JC.clean_masks_device(jnp.asarray(masks), JCFG))
    got, _ = TC.clean_masks_device(_t(masks), CFG)
    np.testing.assert_array_equal(got.numpy(), want)
    empty, capped = TC.clean_masks_device(torch.zeros((0, H, W), dtype=bool))
    assert empty.shape == (0, H, W) and capped.shape == (0,)


# --------------------------------------------------------------------------
# sketch NMS and the front
# --------------------------------------------------------------------------


def test_integral_nonzero_is_int32_and_matches_jax(data):
    from inklayer_tpu.native import integral_nonzero

    gray = data[0]
    got = TN.integral_nonzero(gray)
    assert got.dtype == np.int32 and got.shape == (H + 1, W + 1)
    assert got[-1, -1] == int((gray > 0).sum()) > 0
    np.testing.assert_array_equal(got, integral_nonzero(gray))


def test_nms_prefilter_matches_jax(data):
    gray, _, _, boxes, scores = data
    got = TN.nms_host_prefilter(boxes, scores, gray, CFG)
    want = JN.nms_host_prefilter(boxes, scores, gray, JCFG)
    assert 0 < len(got[0]) < len(boxes)  # the prefilter drops some boxes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ink_iou_matrix_matches_jax(data):
    gray, masks = data[:2]
    ink = gray < 250
    want = np.asarray(JN.ink_mask_iou_matrix(jnp.asarray(masks),
                                             jnp.asarray(ink)))
    got = TN.ink_mask_iou_matrix(_t(masks), _t(ink)).numpy()
    np.testing.assert_allclose(got, want, **FLOAT)


@pytest.mark.parametrize("nms_iou", [0.2, 0.05])
def test_sketch_nms_matches_jax_and_the_host_reference(data, nms_iou):
    """The runner's NMS: the host prefilter, then the keep flags of the
    front, against the JAX package's sketch_nms and its literal
    double-loop reference."""
    import dataclasses

    gray, masks, depth, boxes, scores = data
    cfg = dataclasses.replace(CFG, nms_iou=nms_iou)
    jcfg = dataclasses.replace(JCFG, nms_iou=nms_iou)
    kept0, order, gate, iou_bbox = TN.nms_host_prefilter(boxes, scores, gray,
                                                         cfg)
    keep, _, _ = TF.nms_depth_front(kept0, gate, iou_bbox, order, _t(masks),
                                    _t(gray), _t(depth), cfg)
    got = kept0[order[keep]]
    want = JN.sketch_nms(boxes, scores, masks, gray, jcfg)
    ref = JN._sketch_nms_host_reference(boxes, scores, masks, gray, jcfg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert 0 < len(got) < len(kept0)


def test_greedy_nms_matches_jax(rng):
    k = 12
    iou = rng.random((k, k)).astype(np.float32)
    gate = rng.random((k, k)) > 0.4
    bb = (rng.random((k, k)) * gate).astype(np.float32)
    order = rng.permutation(k)
    want = np.asarray(JN._greedy_nms_device(
        jnp.asarray(iou), jnp.asarray(gate), jnp.asarray(bb),
        jnp.asarray(order), 0.5, 0.7))
    got = TN.greedy_nms(_t(iou), _t(gate), _t(bb), _t(order), 0.5, 0.7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_depth_front_matches_jax(data):
    gray, masks, depth, boxes, scores = data
    kept0, order, gate, iou_bbox = JN.nms_host_prefilter(boxes, scores, gray,
                                                         JCFG)
    k = len(kept0)
    jk, jd, jo = JF.nms_depth_front(kept0, gate, iou_bbox, order,
                                    jnp.asarray(masks), jnp.asarray(gray),
                                    jnp.asarray(depth), JCFG)
    keep, dscores, overlap = TF.nms_depth_front(
        kept0, gate, iou_bbox, order, _t(masks), _t(gray), _t(depth), CFG)
    np.testing.assert_array_equal(keep, np.asarray(jk)[:k])
    np.testing.assert_allclose(dscores, np.asarray(jd)[:k], **FLOAT)
    np.testing.assert_array_equal(overlap, np.asarray(jo)[:k, :k])
    assert overlap.any() and not keep.all()


# --------------------------------------------------------------------------
# depth sort
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cell", [1, 5, 7])
def test_stroke_sampling_and_depth_scores_match_jax(data, cell):
    gray, masks, depth = data[:3]
    ink = gray <= 127
    jp, jv = JS.sample_stroke_points(jnp.asarray(ink), cell)
    tp, tv = TS.sample_stroke_points(_t(ink), cell)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.asarray(JS.mask_depth_scores(jnp.asarray(masks), jp, jv,
                                           jnp.asarray(depth), 0.1))
    got = TS.mask_depth_scores(_t(masks), tp, tv, _t(depth), 0.1).numpy()
    np.testing.assert_allclose(got, want, **FLOAT)


def test_major_overlap_and_sort_order_match_jax(data):
    gray, masks, depth, boxes, _ = data
    ink = gray <= 127
    m = masks & ink[None]
    want = np.asarray(JS.major_overlap_matrix(jnp.asarray(m), thr=0.6))
    got = TS.major_overlap_matrix(_t(m), thr=0.6).numpy()
    np.testing.assert_array_equal(got, want)
    cont = TS.containment_graph(boxes, (H, W), CFG)
    np.testing.assert_array_equal(cont, JS.containment_graph(boxes, (H, W),
                                                             JCFG))
    scores = np.asarray([0.3, 0.1, 0.5, 0.5, 0.2, 0.9, 0.4, 0.0, 0.7, 0.6])
    assert TS.sort_order(scores, cont, got) == JS.sort_order(scores, cont,
                                                             want)


# --------------------------------------------------------------------------
# distance fields
# --------------------------------------------------------------------------


def test_chamfer_distance_matches_jax(data):
    seeds = data[0] < 128
    want = np.asarray(JD.chamfer_distance(jnp.asarray(seeds), iters=64))
    got = TD.chamfer_distance(_t(seeds), iters=64).numpy()
    np.testing.assert_allclose(got, want, **FLOAT)
    small = data[1][:, ::4, ::4]
    want = np.asarray(JD.masked_nearest_distance(jnp.asarray(small), 12))
    got = TD.chamfer_distance(_t(small), 12).numpy()
    np.testing.assert_allclose(got, want, **FLOAT)


def test_label_flood_matches_jax(rng):
    markers = np.zeros((40, 48), np.int32)
    markers[5, 5], markers[30, 40], markers[20, 10:14] = 1, 2, 3
    cost = rng.random((40, 48)).astype(np.float32) * 2.0 - 0.5
    region = rng.random((40, 48)) > 0.2
    want = np.asarray(JD.label_flood(jnp.asarray(markers), jnp.asarray(cost),
                                     jnp.asarray(region), iters=60))
    got = TD.label_flood(_t(markers), _t(cost), _t(region), iters=60).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 4


# --------------------------------------------------------------------------
# refiner
# --------------------------------------------------------------------------


def test_composite_and_clean_delicate_match_jax(data):
    masks = data[1]
    np.testing.assert_array_equal(
        TR.composite_masks(_t(masks)).numpy(),
        np.asarray(JR.composite_masks(jnp.asarray(masks))))
    np.testing.assert_array_equal(
        TR.clean_delicate(_t(masks)).numpy(),
        np.asarray(jnp.stack([JR.clean_delicate(jnp.asarray(m))
                              for m in masks])))


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4, 6, 7, 8, 9],
                                   [5, 3, 1, 0, 2]])
def test_parse_masks_to_disjoint_matches_jax(data, order):
    """The second order leads with the full-image mask, which the > 90%
    ink-cover rule drops."""
    gray, masks, depth, boxes, _ = data
    want, w_boxes, w_info = JR.parse_masks_to_disjoint(
        masks, boxes, gray, depth, JCFG, sort_result=order)
    got, g_boxes, g_info = TR.parse_masks_to_disjoint(
        _t(masks), boxes, _t(gray), CFG, sort_result=order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(g_boxes), np.asarray(w_boxes))
    assert [i["original_indices"] for i in g_info] == \
        [i["original_indices"] for i in w_info]


@pytest.fixture(scope="module")
def disjoint(data):
    gray, masks, depth, boxes, _ = data
    order = [0, 1, 2, 3, 4, 6, 7, 8, 9]
    d, sboxes, _ = JR.parse_masks_to_disjoint(masks, boxes, gray, depth, JCFG,
                                              sort_result=order)
    return np.asarray(d), np.asarray(sboxes)


def test_watershed_expand_matches_jax(data, disjoint):
    gray = data[0]
    ink = gray <= 250
    d = disjoint[0].copy()
    d[:, :, 20:40] = False  # leave ink unlabeled for the flood to fill
    d[:, 70:90, :] = False
    want = np.asarray(JR.watershed_expand(jnp.asarray(d), jnp.asarray(ink),
                                          iters=64))
    got = TR.watershed_expand(_t(d), _t(ink), iters=64).numpy()
    np.testing.assert_array_equal(got, want)
    # the flood labels more ink than the masks covered
    assert (got.any(0) & ink).sum() > (d.any(0) & ink).sum()


def test_box_matching_and_assignment_match_jax(data, disjoint):
    gray = data[0]
    d, sboxes = disjoint
    boxes = sboxes.astype(np.float32)
    want_iou = np.asarray(JR._mask_bboxes_and_iou(jnp.asarray(d),
                                                  jnp.asarray(boxes)))
    got_iou = TR._mask_bboxes_and_iou(_t(d), _t(boxes)).numpy()
    np.testing.assert_allclose(got_iou, want_iou, **FLOAT)
    np.testing.assert_array_equal(
        TR.greedy_match(want_iou),
        np.asarray(JR._greedy_match_device(jnp.asarray(want_iou))))
    want = np.asarray(JR.refine_with_boxes(d, sboxes, gray, JCFG))
    got = TR.refine_with_boxes(_t(d), sboxes, _t(gray), CFG).numpy()
    np.testing.assert_array_equal(got, want)


def test_improve_masks_deferred_matches_jax(data, disjoint):
    gray = data[0]
    d, sboxes = disjoint
    want, want_has = JR.improve_masks_deferred(d, sboxes, gray, JCFG)
    got, has = TR.improve_masks_deferred(_t(d), sboxes, _t(gray), CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(has) == bool(want_has)
    extra, has0 = TR.improve_masks_deferred(torch.zeros((0, H, W), dtype=bool),
                                            np.zeros((0, 4)), _t(gray), CFG)
    want0, _ = JR.improve_masks_deferred(jnp.zeros((0, H, W), bool),
                                         np.zeros((0, 4)), gray, JCFG)
    np.testing.assert_array_equal(extra.numpy(), np.asarray(want0))
    assert bool(has0)
