"""Pipeline factory: build the detector, the SAM predictor, the depth
estimator and the (lazily built) inpainter with seeded placeholder
parameters on an explicit device (port of :mod:`inklayer_tpu.build`).

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
from PIL import Image
from torch import nn

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.models.depth import DepthAnythingV2, DepthEstimator
from inklayer_tpu_torch.models.gdino import GDinoDetector, GroundingDINO
from inklayer_tpu_torch.models.sam import Sam, SamPredictor
from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.pipeline.inpaint.orchestrate import Inpainter
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


def build_diffusion_models(cfg: PipelineConfig, device, dtype: torch.dtype,
                           seed: int = 0) -> dict:
    """The CLIP text encoder, the UNet, the ControlNet and the VAE of
    ``cfg.diffusion`` with placeholder params, on ``device`` in ``dtype``
    (the conv stacks channels-last)."""
    from inklayer_tpu_torch.models.diffusion import (
        AutoencoderKL, CLIPTextEncoder, ControlNet, UNet2DCondition)
    d = cfg.diffusion
    dev = resolve_device(device)
    models = {
        "text": CLIPTextEncoder(hidden=d.cross_attention_dim,
                                heads=max(1, d.cross_attention_dim // 64),
                                max_len=d.text_maxlen),
        # SD1.5's "attention_head_dim" 8 is its number of heads
        "unet": UNet2DCondition(block_channels=d.unet_block_channels,
                                layers_per_block=d.unet_layers_per_block,
                                num_heads=d.unet_attention_head_dim,
                                context_dim=d.cross_attention_dim),
        "controlnet": ControlNet(block_channels=d.unet_block_channels,
                                 layers_per_block=d.unet_layers_per_block,
                                 num_heads=d.unet_attention_head_dim,
                                 context_dim=d.cross_attention_dim),
        "vae": AutoencoderKL(d.vae_channels, d.latent_channels),
    }
    for i, (name, model) in enumerate(models.items()):
        model = init_placeholder_params(model, seed + 3 + i)
        model = model.to(device=dev, dtype=dtype).eval()
        if name != "text":
            model = model.to(memory_format=torch.channels_last)
        models[name] = model
    return models


def build_inpainter(cfg: PipelineConfig, device="cuda",
                    dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0) -> Inpainter:
    """The ControlNet-inpaint stage.  The diffusion models are built on
    first use (the reference's lazy singleton); ``get_pipeline()`` returns
    the :class:`ControlNetInpaintPipeline`.  A CUDA device without a card
    raises here, not at first use."""
    from inklayer_tpu_torch.models.diffusion import ControlNetInpaintPipeline
    from inklayer_tpu_torch.pipeline.inpaint.prepost import (
        preprocess_image, preprocess_mask)
    resolve_device(device)
    state = {}

    def pipe():
        if "pipe" not in state:
            state["pipe"] = ControlNetInpaintPipeline(
                build_diffusion_models(cfg, device, dtype, seed),
                cfg.diffusion)
            state["fn"] = state["pipe"].inpaint_fn()
            state["batch_fn"] = state["pipe"].inpaint_batch_fn()
        return state["pipe"]

    def inpaint_func(image, mask):
        pipe()
        return state["fn"](image, mask)

    def inpaint_batch_func(pairs):
        pipe()
        return state["batch_fn"](pairs)

    def single_layer_func(image, mask, prompt):
        """Text-guided single-layer edit: the user's prompt, the fixed
        negative, cfg 7.0, cond 0.6, one pass, no sketch post-processing;
        the result resized back to the input size."""
        d = cfg.diffusion
        out = pipe().generate(
            preprocess_image(image), preprocess_mask(mask), prompt=prompt,
            negative_prompt=d.single_layer_negative_prompt,
            guidance_scale=d.single_layer_guidance_scale,
            cond_scale=d.single_layer_controlnet_scale, num_passes=1)
        return out.resize(image.size, Image.LANCZOS)

    ink = Inpainter(inpaint_func, single_layer_func=single_layer_func,
                    inpaint_batch_func=inpaint_batch_func)
    ink.get_pipeline = pipe
    return ink


def build_pipeline(cfg: PipelineConfig = PipelineConfig(), device="cuda",
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                   vocab_path: Optional[str] = None) -> InkLayerPipeline:
    """Detector, SAM predictor, depth estimator and inpainter on ``device``
    in ``dtype`` (bf16 on the card; LayerNorm, softmax and sampling
    statistics stay fp32)."""
    return InkLayerPipeline(build_detector(cfg, device, dtype, seed, vocab_path),
                            build_sam(cfg, device, dtype, seed),
                            build_depth(cfg, device, dtype, seed), cfg,
                            inpainter=build_inpainter(cfg, device, dtype,
                                                      seed))
