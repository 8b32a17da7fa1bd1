"""The port's writers against the JAX package's: PNG pixels, the pastel
palette, the mask colouring of the sketch and the box overlay.  All numpy /
PIL, so equality is exact."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.io import outputs as J
from inklayer_tpu.ops import color as JC
from inklayer_tpu_torch.io import outputs as T
from inklayer_tpu_torch.ops import color as TC


def _read(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (8, 1)])
def test_save_png_pixels_match_jax(tmp_path, shape):
    arr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    T.save_png(str(tmp_path / "t.png"), arr)
    J.save_png(str(tmp_path / "j.png"), arr)
    np.testing.assert_array_equal(_read(tmp_path / "t.png"), arr)
    np.testing.assert_array_equal(_read(tmp_path / "t.png"),
                                  _read(tmp_path / "j.png"))


def test_masks_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    masks = rng.random((3, 29, 41)) > 0.5  # width not a multiple of 8
    T.save_masks_dir(masks, str(tmp_path / "t"))
    J.save_masks_dir(masks, str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for i, m in enumerate(masks):
        got = np.asarray(Image.open(tmp_path / "t" / f"mask_{i}.png")
                         .convert("L")) > 127
        want = np.asarray(Image.open(tmp_path / "j" / f"mask_{i}.png")
                          .convert("L")) > 127
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 5, 64])
def test_pastel_colors_match_jax(n):
    assert TC.generate_pastel_colors(n) == JC.generate_pastel_colors(n)


@pytest.mark.parametrize("kind", ["rgb", "gray_rgb", "faint", "blank"])
@pytest.mark.parametrize("n", [0, 1, 6])
def test_label_map_colouring_equals_jax_per_mask_colouring(kind, n):
    """Overlapping masks: the last one covering a pixel wins in both."""
    rng = np.random.default_rng(2)
    sketch = np.full((48, 64, 3), 255, np.uint8)
    ink = rng.random((48, 64)) < 0.3
    if kind == "rgb":
        sketch[ink] = rng.integers(0, 250, (int(ink.sum()), 3))
    elif kind == "gray_rgb":
        sketch[ink] = rng.integers(0, 250, (int(ink.sum()), 1))
    elif kind == "faint":  # max stroke opacity <= 0.1: the other branch
        sketch[ink] = 240
    masks = rng.random((n, 48, 64)) > 0.4
    labels = TC.mask_label_map(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(
        TC.color_sketch_by_label_map(sketch, labels, n),
        JC.color_sketch_by_masks(sketch, list(masks)))


def test_box_overlay_matches_jax():
    sketch = np.full((48, 64, 3), 255, np.uint8)
    sketch[10:30, 5:40] = 0
    image = Image.fromarray(sketch)
    boxes = [[0.1, 0.2, 0.5, 0.7], [0.3, 0.1, 0.9, 0.6]]
    got = T.draw_boxes_image(image, boxes, [0.9, 0.4], labels=["a", "b"])
    want = J.draw_boxes_image(image, boxes, [0.9, 0.4], labels=["a", "b"])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
