"""Image preprocessing: resize scales, shape buckets, resample-and-pad.

Port of :mod:`inklayer_tpu.ops.image`.  The JAX package resamples with
``jax.image.scale_and_translate`` / ``jax.image.resize``: half-pixel
centres, a triangle (bilinear) or Keys cubic (a = -0.5, bicubic) kernel
widened by the inverse scale on downscale (antialias), weights normalised
per output sample and zeroed where the sample falls outside the input.
``F.interpolate`` does none of that (its bicubic is a = -0.75 with another
antialias), so the port builds the same per-axis weight matrices in numpy
with jax's arithmetic (float32) and applies them as matmuls.

The device copies of those matrices (and of other host constants, such as
the depth model's normalisation) come from :func:`on_device`, a bounded
cache per (host key, device, dtype): a pageable upload synchronises the
stream and cannot be captured in a CUDA graph, so a resize pays it once
per matrix, not once per call.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch


def resize_scale(in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                 keep_aspect: str = "longest") -> float:
    """'longest': ResizeLongestSide (SAM); 'shortest': shorter side ==
    min(out) (GDINO)."""
    h, w = in_hw
    oh, ow = out_hw
    if keep_aspect == "longest":
        return min(oh / h, ow / w)
    return max(oh / h, ow / w)


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]
                ) -> Tuple[int, int]:
    """The bucket whose aspect ratio is closest to the image's."""
    aspect = w / h
    return min(buckets, key=lambda b: abs((b[1] / b[0]) - aspect))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax.image's Keys cubic kernel (a = -0.5) on x >= 0, in float32."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0),
                   ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0),
                   out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(f32)


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, scale: float,
                  translation: float = 0.0, antialias: bool = True,
                  kernel: str = "triangle") -> np.ndarray:
    """(n_out, n_in) float32 matrix of jax.image's 1-D resampler
    (``compute_weight_mat`` with the triangle or the Keys cubic kernel).
    Cached per argument set; callers must not modify it."""
    f32 = np.float32
    scale = f32(scale)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(translation) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    if kernel == "triangle":
        weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    elif kernel == "cubic":
        weights = _keys_cubic(x)
    else:
        raise ValueError(f"unknown resampling kernel {kernel!r}")
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    eps = f32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in) - f32(0.5))
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


_KERNELS = {"bilinear": "triangle", "bicubic": "cubic"}


def resize_matrix(n_in: int, n_out: int, antialias: bool = True,
                  method: str = "bilinear") -> np.ndarray:
    """(n_out, n_in) matrix of the 1-D ``jax.image.resize`` operator
    (scale = n_out / n_in; jax leaves equal sizes untouched)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    return weight_matrix(n_in, n_out, np.float32(n_out / n_in),
                         antialias=antialias, kernel=_KERNELS[method])


DEVICE_ENTRIES = 64  # device copies :func:`on_device` keeps (LRU)

_device: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_device_lock = threading.Lock()
_scope = threading.local()


def on_device(make: Callable[..., np.ndarray], args: tuple,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``make(*args)``, a float32 host array, as a tensor on ``device`` in
    ``dtype``; each (make, args, device, dtype) is uploaded once and kept
    while among the last :data:`DEVICE_ENTRIES` used.  The tensor is shared
    by every caller: read it, never write it.  Inside :func:`holding`, the
    held tensors are looked up first and every tensor returned is held."""
    key = (make, args, device, dtype)
    held = getattr(_scope, "held", None)
    if held is not None and key in held:
        return held[key]
    with _device_lock:
        t = _device.get(key)
        if t is None:
            # a plain tensor even under inference mode: training saves
            # these matrices for its backward pass
            with torch.inference_mode(False):
                t = torch.from_numpy(np.asarray(make(*args))).to(device, dtype)
            _device[key] = t
            if len(_device) > DEVICE_ENTRIES:
                _device.popitem(last=False)
        else:
            _device.move_to_end(key)
    if held is not None:
        held[key] = t
    return t


@contextlib.contextmanager
def holding(held: Dict[tuple, torch.Tensor]):
    """While open, :func:`on_device` on this thread answers from ``held``
    first and adds to it what it returns: a CUDA graph captured inside
    keeps every constant it reads (the cache may drop them), and a capture
    that follows an eager call holding the same dict uploads nothing."""
    outer = getattr(_scope, "held", None)
    _scope.held = held
    try:
        yield held
    finally:
        _scope.held = outer


def _vector(*values: float) -> np.ndarray:
    return np.asarray(values, dtype=np.float32)


def device_vector(values: Sequence[float], device: torch.device
                  ) -> torch.Tensor:
    """``values`` as a float32 vector on ``device`` (:func:`on_device`)."""
    return on_device(_vector, tuple(values), device, torch.float32)


def resize(image: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "bilinear", antialias: bool = True) -> torch.Tensor:
    """(H, W, ...) float -> (out_h, out_w, ...): ``jax.image.resize`` over
    the two leading axes, trailing axes kept."""
    h, w = image.shape[:2]
    dev, dt = image.device, image.dtype
    wh = on_device(resize_matrix, (h, out_hw[0], antialias, method), dev, dt)
    ww = on_device(resize_matrix, (w, out_hw[1], antialias, method), dev, dt)
    x = image.reshape(h, w, -1)
    x = torch.einsum("oh,hwc->owc", wh, x)
    x = torch.einsum("pw,owc->opc", ww, x)
    return x.reshape(out_hw[0], out_hw[1], *image.shape[2:])


def align_corners_args(n_in: int, n_out: int) -> tuple:
    """:func:`weight_matrix`'s arguments for an align_corners=True resize
    of one axis: s = (out-1)/(in-1), translation 0.5 - 0.5 s, no
    antialias."""
    s = (n_out - 1) / max(n_in - 1, 1) if n_out > 1 else 1.0
    return (n_in, n_out, np.float32(s), np.float32(0.5 - 0.5 * s), False)


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bilinear resize of the two LAST axes (..., H, W) with torch
    ``align_corners=True`` semantics, as the JAX package expresses it
    (:func:`align_corners_args`)."""
    in_h, in_w = x.shape[-2:]
    mh, mw = (on_device(weight_matrix, align_corners_args(n_in, n_out),
                        x.device, x.dtype)
              for n_in, n_out in ((in_h, out_hw[0]), (in_w, out_hw[1])))
    return torch.matmul(torch.matmul(mh, x), mw.T)


def resize_batch(x: torch.Tensor, out_hw: Tuple[int, int],
                 antialias: bool = True) -> torch.Tensor:
    """(N, H, W) float resize as two separable matmuls — the same linear map
    as ``jax.image.resize(..., 'bilinear')``."""
    _, h, w = x.shape
    oh, ow = out_hw
    wh = torch.from_numpy(resize_matrix(h, oh, antialias)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_matrix(w, ow, antialias)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.T)


def scale_pad_normalize(image: torch.Tensor, scale_hw: Tuple[float, float],
                        mean: Sequence[float], std: Sequence[float],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Normalise, then resample by (scale_h, scale_w) into a zero-padded
    top-left anchored (out_h, out_w, 3) float32 canvas.

    image: (H, W, 3) uint8 or float tensor."""
    h, w = image.shape[:2]
    dev = image.device
    x = image.float()
    x = (x - torch.tensor(mean, dtype=torch.float32, device=dev)) \
        / torch.tensor(std, dtype=torch.float32, device=dev)
    wh = torch.from_numpy(weight_matrix(h, out_hw[0], scale_hw[0])).to(dev)
    ww = torch.from_numpy(weight_matrix(w, out_hw[1], scale_hw[1])).to(dev)
    return torch.einsum("oh,hwc,pw->opc", wh, x, ww)
