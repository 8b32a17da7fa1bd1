"""Port parity: the inpainting sampler and host code against the JAX
package on the CPU.

* The sampler (``ControlNetInpaintPipeline._sample`` / ``_sample_batch``)
  at the TINY diffusion config (tests/test_diffusion.py) with the models
  of tests/test_torch_diffusion.py and the SAME injected noise, fp32:
  relative L2 error <= 1e-4 on the decoded image; the mask-latent resize
  (JAX's "nearest" = pixel centres) exactly; ``generate_batch`` equal to
  independent ``generate`` calls (port only, as tests/test_diffusion.py).
* Pre/post-processing (the JAX package calls OpenCV, the port its own
  numpy): uint8 results within 1 grey level, binarised outputs equal on
  >= 99.9% of pixels (measured: the bilateral filter differs by 1 level
  on ~1e-5 of pixels, float32 rounding; everything else is equal).
* Masks and layer assembly (the JAX package calls scipy.ndimage, the port
  its own 4-connected labelling and exact distance transform): equal
  exactly on the circle sketch of tests/test_inpaint_masks.py and on a
  seeded multi-shape sketch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from inklayer_tpu.models.diffusion.pipeline import (
    ControlNetInpaintPipeline as JaxPipe, _solver_tables)
from inklayer_tpu.models.diffusion import DPMSolverMultistepScheduler
from inklayer_tpu.pipeline.inpaint import masks as JM
from inklayer_tpu.pipeline.inpaint import orchestrate as JO
from inklayer_tpu.pipeline.inpaint import prepost as JP
from inklayer_tpu_torch.models.diffusion import ControlNetInpaintPipeline
from inklayer_tpu_torch.pipeline.inpaint import masks as TM
from inklayer_tpu_torch.pipeline.inpaint import orchestrate as TO
from inklayer_tpu_torch.pipeline.inpaint import prepost as TP
from tests.test_diffusion import TINY
from tests.test_inpaint_masks import _circle_sketch
from tests.test_torch_diffusion import diffusion_pair

REL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32).transpose(
        0, 3, 1, 2), order="C"))


def jax_noise(seed, port_shape):
    """jax.random.normal(key(seed)) in the JAX package's NHWC layout,
    returned in the port's channel-first layout."""
    lead, (c, h, w) = tuple(port_shape[:-3]), tuple(port_shape[-3:])
    z = np.asarray(jax.random.normal(jax.random.key(seed), lead + (h, w, c)))
    return torch.from_numpy(np.array(np.moveaxis(z, -1, -3), order="C"))


def pipelines(cfg=TINY):
    """(JAX pipeline, port pipeline) over the same params; the port draws
    the JAX package's noise."""
    pair = diffusion_pair(cfg)
    jax_pipe = JaxPipe({k: v[1] for k, v in pair.items()}, cfg)
    port = ControlNetInpaintPipeline({k: v[2] for k, v in pair.items()}, cfg)
    port.initial_noise = jax_noise
    return jax_pipe, port


@pytest.fixture(scope="module")
def pipes():
    return pipelines()


def _sample_inputs(rng, b):
    s = TINY.resolution
    img = rng.random((b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 10:40, 20:50] = 1.0
    mask[1:, 30:60, 5:25] = 1.0
    ctrl = img.copy()
    ctrl[mask[..., 0] > 0.5] = -1.0
    noise = rng.standard_normal((b, s // 8, s // 8, 4)).astype(np.float32)
    return img, mask, ctrl, noise


def _jnp(tables):
    return tuple(jnp.asarray(t) for t in tables)


def test_mask_latent_resize_equals_jax_nearest(rng):
    m = (rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (2, 8, 8, 1),
                                       "nearest"))
    got = torch.nn.functional.interpolate(_nchw(m), size=(8, 8),
                                          mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_sample_matches_jax_with_the_same_noise(pipes, rng):
    jax_pipe, port = pipes
    img, mask, ctrl, noise = _sample_inputs(rng, 1)
    tables = _solver_tables(DPMSolverMultistepScheduler(), 2)
    text = jax_pipe._encode_prompt("a b", "c")
    want = jax_pipe._sample(jax_pipe.params, text, jnp.asarray(img[0]),
                            jnp.asarray(mask[0]), jnp.asarray(ctrl[0]),
                            jnp.asarray(noise), _jnp(tables), steps=2,
                            guidance=9.0, cond_scale=1.2)
    got = port._sample(port.encode_prompt("a b", "c"), _nchw(img)[0],
                       _nchw(mask)[0], _nchw(ctrl)[0], _nchw(noise), tables,
                       steps=2, guidance=9.0, cond_scale=1.2)
    assert got.shape == (3, 64, 64)
    assert _rel(got.permute(1, 2, 0).numpy(), want) <= REL
    assert port.stage_times["steps"] == 2


def test_sample_batch_matches_jax_with_the_same_noise(pipes, rng):
    jax_pipe, port = pipes
    img, mask, ctrl, noise = _sample_inputs(rng, 2)
    tables = _solver_tables(DPMSolverMultistepScheduler(), 2)
    text = jax_pipe._encode_prompt("a b", "c")
    want = jax_pipe._sample_batch(
        jax_pipe.params, text, jnp.asarray(img), jnp.asarray(mask),
        jnp.asarray(ctrl), jnp.asarray(noise), _jnp(tables), steps=2,
        guidance=9.0, cond_scale=1.2)
    got = port._sample_batch(port.encode_prompt("a b", "c"), _nchw(img),
                             _nchw(mask), _nchw(ctrl), _nchw(noise), tables,
                             steps=2, guidance=9.0, cond_scale=1.2)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) <= REL


def _layer_images(rng, n, size=48):
    imgs, masks = [], []
    for i in range(n):
        a = np.full((size, size, 3), 255, np.uint8)
        a[rng.random((size, size)) < 0.15] = 0
        m = np.zeros((size, size), np.uint8)
        m[5 + 3 * i: 30 + 2 * i, 8: 35 - i] = 255
        imgs.append(Image.fromarray(a))
        masks.append(Image.fromarray(m))
    return imgs, masks


def test_generate_batch_equals_independent_generate_calls(pipes, rng):
    """Three layers: one bucket of 4 with a padded row; each layer's two
    passes as generate() would run them."""
    _, port = pipes
    cfg_steps = dict(steps=2, num_passes=2)
    imgs, masks = _layer_images(rng, 3)
    batch = port.generate_batch(imgs, masks, **cfg_steps)
    for im, mk, got in zip(imgs, masks, batch):
        want = port.generate(im, mk, **cfg_steps)
        diff = np.abs(np.asarray(got, int) - np.asarray(want, int))
        assert diff.max() <= 1  # float32 sums over another batch size


def test_inpaint_fn_matches_jax(pipes, rng):
    """preprocess -> generate (one pass, 2 steps, the seed's noise) ->
    resize back -> postprocess -> finalize, in both packages."""
    jax_pipe, port = pipes
    imgs, masks = _layer_images(rng, 1)
    want = np.asarray(jax_pipe.inpaint_fn()(imgs[0], masks[0]), int)
    got = np.asarray(port.inpaint_fn()(imgs[0], masks[0]), int)
    assert got.shape == want.shape
    assert (np.abs(got - want) > 1).mean() <= 1e-3


# ---------------------------------------------------------------------------
# pre/post-processing against OpenCV (through the JAX package)
# ---------------------------------------------------------------------------


def _sketch_rgb(rng, h=120, w=150):
    a = np.full((h, w, 3), 255, np.int32)
    a[rng.random((h, w)) < 0.08] = 0
    a[20:25, 10:140] = 30
    a[30:110, 60:64] = 10
    return (a - rng.integers(0, 60, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _mask_img(h=120, w=150):
    m = np.zeros((h, w), np.uint8)
    m[15:70, 40:120] = 255
    m[60:100, 10:50] = 255
    return Image.fromarray(m)


def _close(got, want, levels=1):
    got, want = np.asarray(got, int), np.asarray(want, int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= levels


@pytest.mark.parametrize("noisy", [False, True])
def test_preprocess_image_matches_opencv(rng, noisy):
    img = _sketch_rgb(rng)
    if noisy:
        img = rng.integers(0, 256, img.shape).astype(np.uint8)
    _close(TP.preprocess_image(Image.fromarray(img)),
           JP.preprocess_image(Image.fromarray(img)))


def test_preprocess_mask_equals_opencv():
    mk = _mask_img()
    np.testing.assert_array_equal(np.asarray(TP.preprocess_mask(mk)),
                                  np.asarray(JP.preprocess_mask(mk)))


def test_make_inpaint_condition_equals_jax(rng):
    img, mk = Image.fromarray(_sketch_rgb(rng)), _mask_img()
    np.testing.assert_array_equal(TP.make_inpaint_condition(img, mk),
                                  JP.make_inpaint_condition(img, mk))


@pytest.mark.parametrize("gray_input", [False, True])
def test_postprocess_result_matches_opencv(rng, gray_input):
    res = rng.integers(0, 256, (120, 150, 3)).astype(np.uint8)
    res[:, :75] = _sketch_rgb(rng)[:, :75]
    orig = _sketch_rgb(rng)
    if gray_input:
        res, orig = res[..., 0], orig[..., 0]
    got = TP.postprocess_result(Image.fromarray(res), Image.fromarray(orig),
                                _mask_img())
    want = JP.postprocess_result(Image.fromarray(res), Image.fromarray(orig),
                                 _mask_img())
    _close(got, want)
    # the binarisation inside: where the result was thresholded to white
    import cv2

    gray = res if gray_input else cv2.cvtColor(res, cv2.COLOR_RGB2GRAY)
    want_t = cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                   cv2.THRESH_BINARY, 11, 2)
    got_t = TP.adaptive_threshold_gaussian(TP.rgb_to_gray(res) if res.ndim == 3
                                           else res)
    assert (got_t == want_t).mean() >= 0.999


def test_cv2_replacements_match_opencv(rng):
    import cv2

    rgb = rng.integers(0, 256, (90, 70, 3)).astype(np.uint8)
    gray = rgb[..., 1]
    np.testing.assert_array_equal(TP.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(
        TP.dilate3x3(gray), cv2.dilate(gray, np.ones((3, 3), np.uint8)))
    for k in (3, 11):
        np.testing.assert_array_equal(TP.gaussian_blur(gray, k),
                                      cv2.GaussianBlur(gray, (k, k), 0))
    f = gray / 255.0
    np.testing.assert_allclose(TP.gaussian_blur(f, 3, 1.0),
                               cv2.GaussianBlur(f, (3, 3), 1), atol=1e-12)
    _close(TP.bilateral_filter(rgb), cv2.bilateralFilter(rgb, 5, 50, 50))


def test_finalize_sketch_equals_jax(rng):
    img = Image.fromarray(_sketch_rgb(rng))
    np.testing.assert_array_equal(np.asarray(TP.finalize_sketch(img)),
                                  np.asarray(JP.finalize_sketch(img)))


# ---------------------------------------------------------------------------
# masks and layer assembly against scipy.ndimage (through the JAX package)
# ---------------------------------------------------------------------------


def multi_shape_sketch(rng, h=160, w=200):
    """Black strokes on white: a circle, an open curve to the border, a
    box with a hole, speckle."""
    g = np.full((h, w), 255, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.sqrt((yy - 60) ** 2 + (xx - 70) ** 2)
    g[np.abs(d - 35) < 2.5] = 0
    g[110:114, 0:120] = 0
    g[20:24, 130:190] = 0
    g[90:94, 130:190] = 0
    g[20:94, 130:134] = 0
    g[20:94, 186:190] = 0
    g[rng.random((h, w)) < 0.002] = 0
    return g


@pytest.mark.parametrize("shape", ["circle", "multi"])
def test_get_mask_equals_jax(rng, shape):
    g = _circle_sketch() if shape == "circle" else multi_shape_sketch(rng)
    for kw in ({}, dict(dilate_iter=10, kernel_size=5, safety_margin=1,
                        stroke_thick=2, border_band=3)):
        m_t, type_t = TM.get_mask(g, **kw)
        m_j, type_j = JM.get_mask(g, **kw)
        assert type_t == type_j
        np.testing.assert_array_equal(m_t, m_j)


@pytest.mark.parametrize("shape", ["circle", "multi"])
def test_create_rgba_layer_equals_jax(rng, shape):
    g = _circle_sketch() if shape == "circle" else multi_shape_sketch(rng)
    rgb = np.repeat(g[..., None], 3, axis=2)
    got, t_type = TM.create_rgba_layer(rgb)
    want, j_type = JM.create_rgba_layer(rgb)
    assert t_type == j_type
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,density", [(0, 0.5), (1, 0.3), (2, 0.7)])
def test_label4_equals_ndimage_label(seed, density):
    m = np.random.default_rng(seed).random((123, 97)) < density
    got, n = TM.label4(m)
    want, n_want = ndimage.label(m)
    assert n == n_want
    np.testing.assert_array_equal(got, want)


def test_distance_transform_is_exact(rng):
    m = ndimage.binary_dilation(rng.random((140, 110)) < 0.01,
                                iterations=12)
    np.testing.assert_array_equal(TM.distance_transform_edt(m),
                                  ndimage.distance_transform_edt(m))
    disk = np.hypot(*np.mgrid[-60:61, -60:61]) < 55
    np.testing.assert_array_equal(TM.distance_transform_edt(disk),
                                  ndimage.distance_transform_edt(disk))


def test_fill_holes_equals_jax(rng):
    m = ndimage.binary_dilation(rng.random((80, 90)) < 0.03, iterations=2)
    for min_area in (0, 5, 50):
        np.testing.assert_array_equal(TM._fill_holes(m, min_area),
                                      JM._fill_holes(m, min_area=min_area))


def layered_masks(h=160, w=200):
    """Three disjoint depth-ordered masks (0 = front) over
    multi_shape_sketch: the circle in front of the box, both in front of
    a large back region, so that layers 1 and 2 need inpainting."""
    yy, xx = np.mgrid[0:h, 0:w]
    front = np.hypot(yy - 60, xx - 70) < 38
    mid = np.zeros((h, w), bool)
    mid[15:100, 90:195] = True
    mid &= ~front
    back = np.zeros((h, w), bool)
    back[5:150, 5:160] = True
    back &= ~front & ~mid
    return [front, mid, back]


def circle_layered_masks(h=128, w=128):
    """Over _circle_sketch: a small disk in front of the circle's disk,
    both in front of a box."""
    yy, xx = np.mgrid[0:h, 0:w]
    front = np.hypot(yy - 70, xx - 40) < 25
    mid = (np.hypot(yy - 64, xx - 64) < 34) & ~front
    back = np.zeros((h, w), bool)
    back[8:120, 8:120] = True
    return [front, mid, back & ~front & ~mid]


@pytest.mark.parametrize("shape", ["circle", "multi"])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_assemble_inpaint_input_equals_jax(rng, index, shape):
    if shape == "circle":
        gray, masks = _circle_sketch(), circle_layered_masks()
    else:
        gray, masks = multi_shape_sketch(rng), layered_masks()
    sketch = np.repeat(gray[..., None], 3, axis=2)
    got = TO.assemble_inpaint_input(masks, index, sketch)
    want = JO.assemble_inpaint_input(masks, index, sketch)
    assert got[3] == want[3] == (index > 0)
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_expand_mask_and_bbox_helpers_equal_jax():
    m = np.zeros((40, 50), bool)
    m[10:20, 5:30] = True
    assert TO.mask_to_bbox(m) == JO.mask_to_bbox(m)
    np.testing.assert_array_equal(TO.expand_mask_to_rect(m, 7),
                                  JO.expand_mask_to_rect(m, 7))
    np.testing.assert_array_equal(TO.mask_within_bbox(m, [8, 12, 25, 40]),
                                  JO.mask_within_bbox(m, [8, 12, 25, 40]))
