"""Inpainting pre- and post-processing (port of
:mod:`inklayer_tpu.pipeline.inpaint.prepost`, which calls OpenCV).

preprocess_image: contrast 1.2 + bilateral denoise (5, 50, 50);
preprocess_mask: 3x3 dilation + 3x3 Gaussian blur;
make_inpaint_condition: masked pixels -> -1.0 control image;
postprocess_result: Gaussian adaptive threshold (11, 2) binarisation and a
soft-mask blend with the original; finalize_sketch: grayscale + unsharp.

PIL stays for the contrast, the resizes and the unsharp mask.  The five
OpenCV calls are re-implemented here in numpy with OpenCV's rules:
reflect-101 borders (replicated for the adaptive threshold), the circular
bilateral window with an L1 colour distance, the fixed-point 8-bit
Gaussian blur with OpenCV's ksize -> sigma rule and error-diffused kernel,
the float32 Gaussian mean of the adaptive threshold, and the fixed-point
RGB -> gray weights.  Their agreement with OpenCV is measured in
``tests/test_torch_inpaint.py``.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def _shifted(padded: np.ndarray, r: int, h: int, w: int, dy: int, dx: int):
    return padded[r + dy: r + dy + h, r + dx: r + dx + w]


def bilateral_filter(img: np.ndarray, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 50.0) -> np.ndarray:
    """cv2.bilateralFilter on (H, W, C) or (H, W) uint8: the taps within
    radius d // 2, space weight exp(-r^2 / 2 s^2), colour weight of the L1
    distance summed over channels, float32 sums, round half to even."""
    arr = img if img.ndim == 3 else img[..., None]
    h, w, cn = arr.shape
    r = max(d // 2, 1)
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    color_w = np.exp(np.arange(256 * cn, dtype=np.float64) ** 2 * gc).astype(
        np.float32)
    pad = np.pad(arr, ((r, r), (r, r), (0, 0)), mode="reflect").astype(np.int32)
    center = arr.astype(np.int32)
    num = np.zeros((h, w, cn), np.float32)
    den = np.zeros((h, w), np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            dist = math.sqrt(dy * dy + dx * dx)
            if dist > r:
                continue
            sw = np.float32(math.exp(dist * dist * gs))
            nb = _shifted(pad, r, h, w, dy, dx)
            wgt = sw * color_w[np.abs(nb - center).sum(-1)]
            num += nb.astype(np.float32) * wgt[..., None]
            den += wgt
    out = np.rint(num * (np.float32(1.0) / den)[..., None])
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def dilate3x3(img: np.ndarray) -> np.ndarray:
    """cv2.dilate with a 3x3 rectangle, one iteration (the border never
    wins the maximum)."""
    h, w = img.shape
    pad = np.pad(img, 1, mode="constant", constant_values=0)
    out = img.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = np.maximum(out, _shifted(pad, 1, h, w, dy, dx))
    return out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel (float64) for the sizes used here: the fixed
    [1, 2, 1] / 4 for ksize 3 and sigma <= 0 (OpenCV's table of small
    kernels), else exp(-x^2 / 2 sigma^2) normalised, with sigma = 0.3
    ((ksize - 1) / 2 - 1) + 0.8 when sigma <= 0."""
    if sigma <= 0 and ksize == 3:
        return np.asarray([0.25, 0.5, 0.25])
    if ksize <= 7 and sigma <= 0:
        raise ValueError(f"ksize {ksize} with sigma <= 0: OpenCV's fixed "
                         "small kernels other than 3 are not carried")
    if sigma <= 0:
        sigma = ksize * 0.15 + 0.35
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


def _fixed_kernel(k: np.ndarray, bits: int = 8) -> np.ndarray:
    """OpenCV's error-diffused fixed-point kernel: the outer taps rounded
    with the error carried inwards, the centre takes the rest of 1 << bits."""
    n = len(k)
    one = 1 << bits
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(n // 2):
        v = k[i] * one + err
        q = int(np.rint(v))
        err = v - q
        out[i] = out[n - 1 - i] = q
    out[n // 2] = one - 2 * int(out[: n // 2].sum())
    return out


def _sep_filter(img: np.ndarray, kx, ky, border: str, dtype) -> np.ndarray:
    ry, rx = len(ky) // 2, len(kx) // 2
    pad = np.pad(img.astype(dtype), ((ry, ry), (rx, rx)), mode=border)
    h, w = img.shape
    rows = sum(kx[i] * pad[:, i: i + w] for i in range(len(kx)))
    return sum(ky[i] * rows[i: i + h] for i in range(len(ky)))


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0
                  ) -> np.ndarray:
    """cv2.GaussianBlur with a square odd kernel and reflect-101 borders:
    uint8 in the bit-exact fixed-point form (8 fractional bits per pass,
    round half up); float images in float64."""
    k = gaussian_kernel(ksize, sigma)
    if img.dtype != np.uint8:
        return _sep_filter(img, k, k, "reflect", np.float64)
    fk = _fixed_kernel(k)
    acc = _sep_filter(img, fk, fk, "reflect", np.int64)
    return np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(..., COLOR_RGB2GRAY): 0.299 R + 0.587 G + 0.114 B in
    15-bit fixed point, round half up."""
    v = rgb.astype(np.int32)
    y = v[..., 0] * 9798 + v[..., 1] * 19235 + v[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


def adaptive_threshold_gaussian(gray: np.ndarray, block: int = 11,
                                c: float = 2.0) -> np.ndarray:
    """cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY, block, c): the float32 Gaussian mean over a block x
    block window with replicated borders, rounded to uint8; 255 where
    gray - mean > -ceil(c)."""
    k = gaussian_kernel(block, 0.0).astype(np.float32)
    mean = _sep_filter(gray, k, k, "edge", np.float32)
    mean = np.clip(np.rint(mean), 0, 255).astype(np.int32)
    return np.where(gray.astype(np.int32) - mean > -math.ceil(c), 255,
                    0).astype(np.uint8)


def preprocess_image(image: Image.Image, enhance_contrast: bool = True,
                     denoise: bool = True) -> Image.Image:
    if enhance_contrast:
        image = ImageEnhance.Contrast(image).enhance(1.2)
    if denoise:
        image = Image.fromarray(bilateral_filter(np.asarray(image), 5, 50, 50))
    return image


def preprocess_mask(mask: Image.Image, dilate_iterations: int = 1,
                    blur_radius: int = 1) -> Image.Image:
    arr = np.asarray(mask.convert("L"))
    for _ in range(dilate_iterations):
        arr = dilate3x3(arr)
    if blur_radius > 0:
        arr = gaussian_blur(arr, blur_radius * 2 + 1)
    return Image.fromarray(arr)


def make_inpaint_condition(init_image: Image.Image,
                           mask_image: Image.Image) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] with masked pixels = -1 (the ControlNet
    inpaint conditioning convention)."""
    img = np.asarray(init_image.convert("RGB"), np.float32) / 255.0
    msk = np.asarray(mask_image.convert("L"), np.float32) / 255.0
    img = img.copy()
    img[msk > 0.5] = -1.0
    return img


def postprocess_result(result: Image.Image, original: Image.Image,
                       mask: Image.Image) -> Image.Image:
    res = np.asarray(result)
    orig = np.asarray(original)
    m = np.asarray(mask.convert("L")) / 255.0
    gray = rgb_to_gray(res) if res.ndim == 3 else res.copy()
    thresh = adaptive_threshold_gaussian(gray, 11, 2)
    if res.ndim == 3:
        clean = np.where(thresh[..., None] > 127, 255, res)
    else:
        clean = np.where(thresh > 127, 255, res)
    soft = np.clip(gaussian_blur(m, 3, 1.0), 0, 1)
    if res.ndim == 3:
        soft = soft[..., None]
    blended = clean * soft + orig * (1 - soft)
    return Image.fromarray(blended.astype(np.uint8))


def finalize_sketch(image: Image.Image) -> Image.Image:
    """Grayscale + unsharp mask."""
    image = image.convert("L").convert("RGB")
    return image.filter(ImageFilter.UnsharpMask(radius=0.5, percent=150,
                                                threshold=3))
