"""Frozen copy of the program's inpainting host pre- and post-processing
(the five OpenCV calls in numpy with OpenCV's rules, PIL for the contrast,
resizes and unsharp mask), the layer's input to the sampler and its
finish: the uint8 cast, the resize back, the threshold blend, the unsharp
mask, and the composite of the original ink; and, before them, a plain
version of the layers' assembly (:func:`assemble`: each layer's image, its
occluders' background silhouettes by ``scipy.ndimage``, its edit mask).

preprocess_image: contrast 1.2 + bilateral denoise (5, 50, 50);
preprocess_mask: 3x3 dilation + 3x3 Gaussian blur;
make_inpaint_condition: masked pixels -> -1.0 control image;
postprocess_result: Gaussian adaptive threshold (11, 2) binarisation and a
soft-mask blend with the original; finalize_sketch: grayscale + unsharp.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter
from scipy import ndimage


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


def to_uint8(image01: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) float in [0, 1] -> uint8 (NaN -> 0, truncating)."""
    arr = np.nan_to_num(image01.astype(np.float32))
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def sampler_inputs(layer: np.ndarray, edit_mask: np.ndarray, size: int):
    """One layer's (image, edit mask) as the sampler takes them: (image01
    (size, size, 3), mask01 (size, size, 1), control (size, size, 3)),
    float32, after the pre-processing and the LANCZOS resize."""
    img = preprocess_image(Image.fromarray(layer))
    msk = preprocess_mask(Image.fromarray(edit_mask.astype(np.uint8) * 255))
    img = img.resize((size, size), Image.LANCZOS)
    msk = msk.resize((size, size), Image.LANCZOS)
    mask01 = np.asarray(msk.convert("L"), np.float32)[..., None] / 255.0
    img01 = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return img01, mask01, make_inpaint_condition(img, msk)


def finish(image_u8: np.ndarray, layer: np.ndarray,
           edit_mask: np.ndarray) -> np.ndarray:
    """The sampler's uint8 image -> the completed layer: resized back to
    the layer's size, thresholded and blended with the layer under the
    edit mask, grayscale with the unsharp mask, the layer's ink on top."""
    out = Image.fromarray(image_u8).resize(
        (layer.shape[1], layer.shape[0]), Image.LANCZOS)
    mask = Image.fromarray(edit_mask.astype(np.uint8) * 255)
    out = np.asarray(finalize_sketch(postprocess_result(
        out, Image.fromarray(layer), mask))).copy()
    ink = (layer < 255).any(axis=-1)
    out[ink] = layer[ink]
    return out


def otsu(gray: np.ndarray) -> int:
    """Otsu's threshold of a uint8 image: the first t with the largest
    between-class variance of {<= t} and {> t}."""
    hist = np.bincount(gray.reshape(-1), minlength=256).astype(np.float64)
    t = np.arange(256)
    w_b = np.cumsum(hist)
    w_f = gray.size - w_b
    sum_b = np.cumsum(t * hist)
    ok = (w_b > 0) & (w_f > 0)
    m_b = np.where(ok, sum_b / np.where(ok, w_b, 1), 0)
    m_f = np.where(ok, (sum_b[-1] - sum_b) / np.where(ok, w_f, 1), 0)
    between = np.where(ok, w_b * w_f * (m_b - m_f) ** 2, -1.0)
    return int(np.argmax(between)) if ok.any() else 0


def ellipse(k: int) -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE element of size k x k."""
    r = k // 2
    se = np.zeros((k, k), bool)
    for i in range(k):
        dy = abs(i - r)
        dx = int(round(r * math.sqrt(max(0.0, 1.0 - dy * dy / (r * r)))))
        se[i, max(0, r - dx): min(k, r + dx + 1)] = True
    return se


def fill_holes(mask: np.ndarray, min_area: int = 0) -> np.ndarray:
    """The mask with its enclosed background components (4-connected, not
    touching the border) of at least ``min_area`` pixels filled."""
    labels, n = ndimage.label(~mask)
    edge = np.unique(np.concatenate([labels[0], labels[-1], labels[:, 0],
                                     labels[:, -1]]))
    area = np.bincount(labels.reshape(-1), minlength=n + 1)
    fill = area >= min_area
    fill[edge] = False
    fill[0] = False
    return mask | fill[labels]


def silhouette(region: np.ndarray) -> np.ndarray:
    """The background silhouette of an occluder's region, as the assembly
    takes it (the sketch's ``get_mask`` of the region drawn black on white,
    element 5, 10 dilations, safety margin 1, stroke 2, border band 3):
    the strokes dilated; where that touches the band, the strokes dilated
    twice with the enclosed holes of 50+ pixels filled; else what the
    corner's background does not reach, its largest component, shrunk by
    the strokes' least distance to its outside less the margin, holes
    filled."""
    inv = np.where(region, 255, 0).astype(np.uint8)
    strokes = inv > otsu(inv)
    se = ellipse(5)
    thick = ndimage.binary_dilation(strokes, se, iterations=10)
    band = 3
    if (thick[:band].any() or thick[-band:].any() or thick[:, :band].any()
            or thick[:, -band:].any()):
        return fill_holes(ndimage.binary_dilation(strokes, se, iterations=2),
                          50)
    outside, _ = ndimage.label(~thick)
    inner = outside != outside[0, 0]
    comps, n = ndimage.label(inner)
    if n > 1:
        area = np.bincount(comps.reshape(-1))
        area[0] = 0
        inner = comps == int(np.argmax(area))
    dist = ndimage.distance_transform_edt(inner)
    if strokes.any():
        by = max(0, int(np.floor(dist[strokes].min())) - 1)
        if by > 0:
            inner = dist >= by
    return fill_holes(inner)


def assemble(masks, sketch: np.ndarray) -> list:
    """(layer image, edit mask or None, inpainted) of each depth-ordered
    bool mask (0 in front) of a sketch: the sketch's ink inside the mask
    on white; for a back layer with a pixel inside an earlier mask's box,
    the union of those occluders' silhouettes inside its own box, less the
    mask.  A box is cut as the program cuts it: [x1, x2) x [y1, y2) of the
    pixels' extremes, so its last row and column fall outside."""
    def box(m):
        ys, xs = np.nonzero(m)
        return (xs.min(), ys.min(), xs.max(), ys.max()) if len(ys) else None

    def within(m, b):
        out = np.zeros_like(m)
        out[b[1]:b[3], b[0]:b[2]] = m[b[1]:b[3], b[0]:b[2]]
        return out

    out, seen = [], {}
    for i, m in enumerate(masks):
        layer = np.where(m[..., None], sketch, 255).astype(np.uint8)
        b = box(m) if i else None
        front = [k for k in range(i) if b is not None
                 and (ob := box(masks[k])) is not None and within(m, ob).any()]
        if not front:
            out.append((layer, None, False))
            continue
        for k in front:
            if k not in seen:
                seen[k] = silhouette(masks[k])
        edit = within(np.logical_or.reduce([seen[k] for k in front]), b)
        out.append((layer, edit & ~m, True))
    return out
