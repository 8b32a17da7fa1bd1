"""Mask cleaning stage (port of
:mod:`inklayer_tpu.pipeline.refine.mask_cleaner`).

refinement/mask_cleaner.py clean_up_mask: threshold -> MORPH_CLOSE with a
rect kernel ~2.5% of the short side (odd; 19 at 750^2) -> keep the
8-connected components with area > min_cc_area or bbox aspect >
min_cc_aspect.  All N masks are cleaned in one batch where they lie; on the
card the component keep is the ``clean_components`` kernel.
"""

from __future__ import annotations

import torch

from inklayer_tpu_torch.config import RefineConfig
from inklayer_tpu_torch.ops import morphology as M
from inklayer_tpu_torch.ops.components import clean_components


def kernel_size(image_hw, factor: float = 0.025) -> int:
    k = int(min(image_hw) * factor)
    return k if k % 2 != 0 else k + 1


def clean_masks(masks: torch.Tensor, k: int, min_area: int = 500,
                min_aspect: float = 1.1):
    """(N, H, W) bool or uint8 -> ((N, H, W) bool cleaned, (N,) bool cap
    flags, all False: the port's components are exact)."""
    binary = masks > (127 if masks.dtype == torch.uint8 else 0)
    closed = M.morph_close(binary, M.rect_kernel(max(k, 1)))
    return clean_components(closed, min_area, min_aspect)


def clean_masks_device(masks: torch.Tensor,
                       cfg: RefineConfig = RefineConfig()):
    """The runner's entry: cleaned masks and cap flags, where the masks
    lie."""
    if masks.shape[0] == 0:
        return masks.bool(), torch.zeros(0, dtype=torch.bool,
                                         device=masks.device)
    k = kernel_size(masks.shape[1:], cfg.clean_kernel_frac)
    return clean_masks(masks, k, cfg.min_cc_area, cfg.min_cc_aspect)
