"""Connected components and the mask-cleaning component keep (port of
:mod:`inklayer_tpu.ops.components`).

Labels follow the JAX package: (N, H, W) int32, -1 at background, each
8-connected component labelled by the smallest linear index y * W + x of
its pixels.  On a CUDA tensor :func:`connected_components` and
:func:`clean_components` launch the union-find kernels of
``csrc/components.cu`` (ports of the Pallas ``_connected_components_pallas``
and ``_clean_components_pallas``: tile-local union-find in shared memory,
then the tile borders in device memory); on a CPU tensor they run the
plain versions below.  Both reach the exact fixpoint: the TPU kernel stops
after 16 propagation steps and examines at most 256 components, the XLA
path after 64 steps and 128 components, so they agree with the port
exactly on every mask the JAX package reports as uncapped.  The port's
cap flags are therefore False by construction; they are returned so the
runner keeps the JAX package's API.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

_BIG = 2 ** 30


def _check_masks(masks: torch.Tensor) -> None:
    if masks.dim() != 3 or masks.dtype != torch.bool:
        raise ValueError(f"components take (N, H, W) bool masks, got "
                         f"{tuple(masks.shape)} {masks.dtype}")


def connected_components_plain(masks: torch.Tensor) -> torch.Tensor:
    """Min-label propagation over the 8 neighbours, repeated to the
    fixpoint with no cap, with the minimum hooked onto each tree's root
    and the pointers compressed after every step (so a winding component
    converges in a few steps, not one step per pixel of its length).

    ``parent`` holds a pointer per pixel, never above the pixel's own
    index and always inside its component (slot H*W is the background's
    sink).  A step takes each pixel's 3x3 minimum label, lowers the
    pixel's root to it (``scatter_reduce`` amin) and compresses; at the
    fixpoint every component carries one root, its smallest index."""
    _check_masks(masks)
    n, h, w = masks.shape
    hw = h * w
    fg = masks.reshape(n, hw)
    idx = torch.arange(hw, device=masks.device)
    parent = torch.cat([torch.where(fg, idx, hw),
                        torch.full((n, 1), hw, device=masks.device)], dim=1)
    while True:
        cur = parent[:, :hw]
        pad = F.pad(cur.reshape(n, h, w), (1, 1, 1, 1), value=hw)
        nmin = cur.reshape(n, h, w)
        for dy in range(3):
            for dx in range(3):
                nmin = torch.minimum(nmin, pad[:, dy:dy + h, dx:dx + w])
        nmin = torch.where(masks, nmin, hw).reshape(n, hw)
        if torch.equal(nmin, cur):
            break
        parent = parent.scatter_reduce(1, cur, nmin, "amin")
        while True:
            nxt = torch.gather(parent, 1, parent)
            if torch.equal(nxt, parent):
                break
            parent = nxt
    return torch.where(masks, parent[:, :hw].reshape(n, h, w),
                       -1).to(torch.int32)


def connected_components(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels (see the module doc)."""
    _check_masks(masks)
    if not use_kernel(masks):
        return connected_components_plain(masks)
    n, h, w = masks.shape
    masks = masks.contiguous()
    labels = torch.empty((n, h, w), dtype=torch.int32, device=masks.device)
    if n == 0:
        return labels
    status = _kernels.lib().ik_connected_components(
        masks.data_ptr(), labels.data_ptr(), n, h, w,
        _kernels.stream(masks.get_device()))
    _kernels.check(status, "connected_components")
    _kernels.count_launch("connected_components")
    return labels


def _keep_rule(area, ymin, ymax, xmin, xmax, min_area: int,
               min_aspect: float) -> torch.Tensor:
    """area > min_area OR max(w, h) / (min(w, h) + 1e-5) > min_aspect, in
    fp32 as components.py:316-319 computes it."""
    ww = (xmax - xmin + 1).float()
    hh = (ymax - ymin + 1).float()
    aspect = torch.maximum(ww, hh) / (torch.minimum(ww, hh) + 1e-5)
    return (area > min_area) | (aspect > min_aspect)


def component_boxes(labels: torch.Tensor):
    """Per-root stats of (N, H, W) labels, as flat (N*H*W,) int64 arrays
    indexed by n*H*W + root: area, ymin, ymax, xmin, xmax (meaningful at
    the roots only), plus the per-pixel flat root index ``seg``."""
    n, h, w = labels.shape
    dev = labels.device
    fg = (labels >= 0).reshape(-1)
    base = (torch.arange(n, device=dev) * (h * w)).reshape(n, 1, 1)
    seg = (labels.clamp(min=0).long() + base).reshape(-1)
    yy = torch.arange(h, device=dev).reshape(1, h, 1).expand(n, h, w)
    xx = torch.arange(w, device=dev).reshape(1, 1, w).expand(n, h, w)
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    size = n * h * w

    def reduce(vals, init, how):
        out = torch.full((size,), init, dtype=torch.long, device=dev)
        return out.scatter_reduce_(0, seg, torch.where(fg, vals, init), how)

    area = torch.zeros(size, dtype=torch.long, device=dev).scatter_add_(
        0, seg, fg.long())
    return (area, reduce(yy, _BIG, "amin"), reduce(yy, -1, "amax"),
            reduce(xx, _BIG, "amin"), reduce(xx, -1, "amax"), seg, fg)


def clean_components_plain(masks: torch.Tensor, min_area: int,
                           min_aspect: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The labels of :func:`connected_components_plain`, per-component
    stats with ``scatter_reduce``, then the keep rule."""
    labels = connected_components_plain(masks)
    area, ymin, ymax, xmin, xmax, seg, fg = component_boxes(labels)
    keep = _keep_rule(area, ymin, ymax, xmin, xmax, min_area, min_aspect)
    cleaned = (keep[seg] & fg).reshape(masks.shape)
    return cleaned, torch.zeros(masks.shape[0], dtype=torch.bool,
                                device=masks.device)


def clean_components(masks: torch.Tensor, min_area: int, min_aspect: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) bool -> ((N, H, W) bool cleaned, (N,) bool cap flags):
    keep the components with area > min_area or bbox aspect > min_aspect
    (mask_cleaner.py clean_up_mask).  The flags are all False: the port's
    components are exact."""
    _check_masks(masks)
    if not use_kernel(masks):
        return clean_components_plain(masks, min_area, min_aspect)
    n, h, w = masks.shape
    dev = masks.device
    masks = masks.contiguous()
    out = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    capped = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, capped
    # scratch: the labels, and the per-root statistics (area, ymax, xmin,
    # xmax) in one cell per 2 x 2 pixels, which holds at most one root
    labels = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    cells = torch.empty((n, (h + 1) // 2, (w + 1) // 2, 4), dtype=torch.int32,
                        device=dev)
    status = _kernels.lib().ik_clean_components(
        masks.data_ptr(), out.data_ptr(), labels.data_ptr(), cells.data_ptr(),
        n, h, w, int(min_area), float(min_aspect),
        _kernels.stream(masks.get_device()))
    _kernels.check(status, "clean_components")
    _kernels.count_launch("clean_components")
    return out, capped


def component_stats(labels: torch.Tensor):
    """(H, W) labels -> per-pixel (area, width, height) of each pixel's
    component, 0 at background (exact, scatter-based; XLA segment ops in
    the JAX package)."""
    area, ymin, ymax, xmin, xmax, seg, fg = component_boxes(labels[None])
    h, w = labels.shape

    def lookup(stat):
        return torch.where(fg, stat[seg], 0).reshape(h, w)

    return (lookup(area), lookup((xmax - xmin + 1).clamp(min=0)),
            lookup((ymax - ymin + 1).clamp(min=0)))


def large_component_mask(mask: torch.Tensor, min_area: int) -> torch.Tensor:
    """(H, W) bool -> True where the pixel's component has area > min_area
    (refiner.py large-region detection)."""
    labels = connected_components(mask[None])[0]
    area, _, _ = component_stats(labels)
    return (area > min_area) & mask
