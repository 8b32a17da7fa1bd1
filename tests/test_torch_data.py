"""Port parity: train-time data — the DETR train transforms and the brush
augmentation against the JAX package's on the same seeds (exactly equal:
same numpy arithmetic), and the numpy ``scipy.ndimage`` filters of
``ops/ndimage.py`` against scipy (exactly equal; scipy is present here,
not on the card's machine)."""

import numpy as np
import pytest
from scipy import ndimage

from inklayer_tpu.pipeline import augment as JA
from inklayer_tpu.pipeline import det_transforms as JDT
from inklayer_tpu_torch.ops import ndimage as N
from inklayer_tpu_torch.pipeline import augment as TA
from inklayer_tpu_torch.pipeline import det_transforms as TDT


def _sketch(h=64, w=64):
    g = np.full((h, w), 255, np.uint8)
    g[20:44, 30:33] = 0
    g[30:33, 10:54] = 0
    g[5:12, 5:60] = 120
    return g


# ---------------------------------------------------------------------------
# det_transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_detr_train_transform_matches_jax(seed):
    img = (np.random.default_rng(100 + seed).random((480, 640, 3)) * 255
           ).astype(np.uint8)
    boxes = np.array([[100.0, 100.0, 400.0, 300.0], [10.0, 20.0, 80.0, 90.0],
                      [600.0, 400.0, 639.0, 479.0]])
    want = JDT.detr_train_transform(np.random.default_rng(seed), img, boxes)
    got = TDT.detr_train_transform(np.random.default_rng(seed), img, boxes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_transform_pieces_match_jax(rng):
    img = (rng.random((300, 900, 3)) * 255).astype(np.uint8)
    boxes = np.array([[90.0, 30.0, 450.0, 150.0], [850.0, 250.0, 899.0, 299.0]])
    for fn, args in (("hflip", (img, boxes)),
                     ("resize_shorter", (img, boxes, 800, 1333)),
                     ("resize_shorter", (img, boxes, 480, None)),
                     ("crop", (img, boxes, (10, 20, 200, 400))),
                     ("boxes_to_cxcywh_norm", (boxes, (300, 900)))):
        want, got = getattr(JDT, fn)(*args), getattr(TDT, fn)(*args)
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    want = JDT.random_size_crop(np.random.default_rng(4), img, boxes)
    got = TDT.random_size_crop(np.random.default_rng(4), img, boxes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("amount", [-2, -1, 0, 1, 2])
def test_stroke_width_jitter_matches_jax(amount):
    g = _sketch()
    np.testing.assert_array_equal(TA.stroke_width_jitter(g, amount),
                                  JA.stroke_width_jitter(g, amount))


@pytest.mark.parametrize("fn,kw", [
    ("elastic_warp", dict(alpha=4.0, seed=1)),
    ("elastic_warp", dict(alpha=8.0, sigma=3.0, seed=5)),
    ("opacity_texture", dict(strength=0.5, seed=2)),
    ("background_tint", dict(tint=0.1, seed=3)),
])
def test_augment_pieces_match_jax(fn, kw):
    g = _sketch(70, 90)
    np.testing.assert_array_equal(getattr(TA, fn)(g, **kw),
                                  getattr(JA, fn)(g, **kw))


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_augment_sketch_with_labels_matches_jax(seed):
    g = _sketch()
    labels = np.zeros((64, 64), np.int32)
    labels[g < 250] = 1
    labels[5:12, 5:60] = 2
    out, wl = TA.augment_sketch(g, labels, seed=seed)
    jout, jwl = JA.augment_sketch(g, labels, seed=seed)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(wl, jwl)
    assert wl.dtype == jwl.dtype


# ---------------------------------------------------------------------------
# the numpy ndimage filters against scipy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (37, 91), (5, 8)])
@pytest.mark.parametrize("size", [1, 3, 5, 7])
def test_min_max_filters_match_scipy(rng, shape, size):
    g = (rng.random(shape) * 255).astype(np.uint8)
    np.testing.assert_array_equal(N.minimum_filter(g, size),
                                  ndimage.minimum_filter(g, size=size))
    np.testing.assert_array_equal(N.maximum_filter(g, size),
                                  ndimage.maximum_filter(g, size=size))


@pytest.mark.parametrize("shape", [(64, 64), (37, 91), (20, 20)])
@pytest.mark.parametrize("sigma", [0.7, 1.5, 6.0, 12.0])
def test_gaussian_filter_matches_scipy(rng, shape, sigma):
    # sigma 12 on 20 x 20: a radius of 48, past the edge more than once
    x = rng.standard_normal(shape)
    np.testing.assert_array_equal(N.gaussian_filter(x, sigma),
                                  ndimage.gaussian_filter(x, sigma))


@pytest.mark.parametrize("order,dtype", [(0, np.int32), (1, np.uint8),
                                         (0, np.uint8), (1, np.float64)])
def test_map_coordinates_matches_scipy(rng, order, dtype):
    h, w = 40, 56
    img = (rng.random((h, w)) * 250).astype(dtype)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dy = rng.standard_normal((h, w)) * 6  # past the edges too
    dx = rng.standard_normal((h, w)) * 6
    for coords in (np.stack([yy + dy, xx + dx]),
                   np.round(np.stack([yy + dy, xx + dx]) * 2) / 2):  # halves
        want = ndimage.map_coordinates(img, coords, order=order,
                                       mode="nearest")
        got = N.map_coordinates(img, coords, order=order)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_map_coordinates_refuses_other_orders():
    with pytest.raises(ValueError, match="order 3"):
        N.map_coordinates(np.zeros((4, 4)), np.zeros((2, 4, 4)), order=3)
