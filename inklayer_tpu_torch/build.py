"""Pipeline factory: build the detector, the SAM predictor and the depth
estimator with seeded placeholder parameters on an explicit device (port
of :mod:`inklayer_tpu.build`, the default run).

No checkpoints ship with the repository.  Placeholder params are a small
random normal (std 0.02) drawn from a seeded ``torch.Generator`` on the
CPU, with LayerNorm / GroupNorm scales 1 and shifts 0, then moved to the
device in the compute dtype.  (The JAX package fills constants; constant
weights make every detection score tie, and ``torch.topk`` and
``lax.top_k`` break ties differently.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.models.depth import DepthAnythingV2, DepthEstimator
from inklayer_tpu_torch.models.gdino import GDinoDetector, GroundingDINO
from inklayer_tpu_torch.models.sam import Sam, SamPredictor
from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.pipeline.runner import InkLayerPipeline
from inklayer_tpu_torch.runtime import resolve_device

PLACEHOLDER_STD = 0.02


@torch.no_grad()
def init_placeholder_params(model: nn.Module, seed: int,
                            std: float = PLACEHOLDER_STD) -> nn.Module:
    """Seeded N(0, std) for every parameter and buffer; norm layers get
    scale 1 and shift 0.  Deterministic for a seed, whatever the device."""
    gen = torch.Generator().manual_seed(seed)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen) * std)
    for m in model.modules():
        if isinstance(m, (LayerNorm, nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def build_detector(cfg: PipelineConfig, device, dtype: torch.dtype,
                   seed: int = 0,
                   vocab_path: Optional[str] = None) -> GDinoDetector:
    model = init_placeholder_params(GroundingDINO(cfg.gdino), seed)
    model = model.to(device=resolve_device(device), dtype=dtype).eval()
    return GDinoDetector(model, vocab_path=vocab_path)


def build_sam(cfg: PipelineConfig, device, dtype: torch.dtype,
              seed: int = 0) -> SamPredictor:
    model = init_placeholder_params(Sam(cfg.sam), seed + 1)
    model = model.to(device=resolve_device(device), dtype=dtype).eval()
    return SamPredictor(model, box_capacity=cfg.gdino.max_boxes)


def build_depth(cfg: PipelineConfig, device, dtype: torch.dtype,
                seed: int = 0) -> DepthEstimator:
    model = init_placeholder_params(DepthAnythingV2(cfg.depth), seed + 2)
    model = model.to(device=resolve_device(device), dtype=dtype).eval()
    return DepthEstimator(model)


def build_pipeline(cfg: PipelineConfig = PipelineConfig(), device="cuda",
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                   vocab_path: Optional[str] = None) -> InkLayerPipeline:
    """Detector, SAM predictor and depth estimator on ``device`` in
    ``dtype`` (bf16 on the card; LayerNorm, softmax and sampling
    statistics stay fp32)."""
    return InkLayerPipeline(build_detector(cfg, device, dtype, seed, vocab_path),
                            build_sam(cfg, device, dtype, seed),
                            build_depth(cfg, device, dtype, seed), cfg)
