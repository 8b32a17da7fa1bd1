"""Pipeline factory: build the detector, the SAM predictor, the depth
estimator and the (lazily built) inpainter on an explicit device (port of
:mod:`inklayer_tpu.build`).

With ``models_dir``, each model loads its reference checkpoint from there
(:mod:`inklayer_tpu_torch.io.weights`), under the JAX package's file names:
``inklayer_gdino.pth``, ``sam_vit_h_4b8939.pth``,
``depth_anything_v2_{encoder}.pth``, the BERT vocab at
``bert-base-uncased/vocab.txt`` or ``vocab.txt``, and the diffusers layout
of :func:`resolve_diffusion_checkpoints`.  A model whose file is absent
gets placeholder params, with a warning when a ``models_dir`` was given.

No checkpoints ship with the repository.  Placeholder params are a small
random normal (std 0.02) drawn from a seeded ``torch.Generator`` on the
CPU, with LayerNorm / GroupNorm scales 1 and shifts 0.  (The JAX package
fills constants; constant weights make every detection score tie, and
``torch.topk`` and ``lax.top_k`` break ties differently.)  Either way the
params are fp32 on the CPU first, then move to the device in the compute
dtype.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import torch
from PIL import Image
from torch import nn

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.io import weights
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


def _first_existing(*paths) -> Optional[str]:
    for p in paths:
        if p and os.path.exists(p):
            return p
    return None


def _params(model: nn.Module, name: str, path: Optional[str],
            models_dir: Optional[str], seed: int,
            ignore: Sequence[str] = ()) -> nn.Module:
    """``model`` with the checkpoint at ``path`` loaded, or with seeded
    placeholder params where there is none (warning when ``models_dir``
    was given: the reference's own behaviour, build.py:245-249)."""
    if path:
        t0 = time.perf_counter()
        weights.load_checkpoint(model, path, ignore)
        print(f"[build] loaded {name} from {path} "
              f"({time.perf_counter() - t0:.1f}s)")
        return model
    if models_dir:
        print(f"[build] WARNING: no {name} checkpoint under {models_dir} — "
              f"using placeholder params (outputs will be noise)")
    return init_placeholder_params(model, seed)


def _ckpt(models_dir: Optional[str], name: str) -> Optional[str]:
    return _first_existing(os.path.join(models_dir, name)) if models_dir \
        else None


def build_detector(cfg: PipelineConfig, device, dtype: torch.dtype,
                   seed: int = 0, vocab_path: Optional[str] = None,
                   models_dir: Optional[str] = None) -> GDinoDetector:
    dev = resolve_device(device)
    model = _params(GroundingDINO(cfg.gdino), "gdino",
                    _ckpt(models_dir, "inklayer_gdino.pth"), models_dir, seed,
                    weights.GDINO_IGNORE)
    if vocab_path is None and models_dir:
        # bert-base-uncased vocab.txt for exact caption tokenization
        vocab_path = _first_existing(
            os.path.join(models_dir, "bert-base-uncased", "vocab.txt"),
            os.path.join(models_dir, "vocab.txt"))
    return GDinoDetector(model.to(device=dev, dtype=dtype).eval(),
                         vocab_path=vocab_path)


def build_sam(cfg: PipelineConfig, device, dtype: torch.dtype,
              seed: int = 0, models_dir: Optional[str] = None) -> SamPredictor:
    dev = resolve_device(device)
    model = _params(Sam(cfg.sam), "sam",
                    _ckpt(models_dir, "sam_vit_h_4b8939.pth"), models_dir,
                    seed + 1)
    return SamPredictor(model.to(device=dev, dtype=dtype).eval(),
                        box_capacity=cfg.gdino.max_boxes)


def build_depth(cfg: PipelineConfig, device, dtype: torch.dtype,
                seed: int = 0, models_dir: Optional[str] = None
                ) -> DepthEstimator:
    dev = resolve_device(device)
    model = _params(DepthAnythingV2(cfg.depth), "depth",
                    _ckpt(models_dir,
                          f"depth_anything_v2_{cfg.depth.encoder}.pth"),
                    models_dir, seed + 2, weights.DEPTH_IGNORE)
    return DepthEstimator(model.to(device=dev, dtype=dtype).eval())


def resolve_diffusion_checkpoints(models_dir: Optional[str]) -> dict:
    """Locate the diffusers-layout component weight files under models_dir
    (as ``huggingface-cli download`` of runwayml/stable-diffusion-inpainting
    and lllyasviel/control_v11p_sd15_inpaint lays them out):

        {models_dir}/stable-diffusion-inpainting/unet/diffusion_pytorch_model.{safetensors,bin}
        {models_dir}/stable-diffusion-inpainting/vae/diffusion_pytorch_model.{safetensors,bin}
        {models_dir}/stable-diffusion-inpainting/text_encoder/{model.safetensors,pytorch_model.bin}
        {models_dir}/control_v11p_sd15_inpaint/diffusion_pytorch_model.{safetensors,bin}
        {models_dir}/clip-vit-large-patch14/{vocab.json,merges.txt}   (tokenizer)

    Returns {component: path-or-None}."""
    out = {"unet": None, "vae": None, "text": None, "controlnet": None,
           "clip_vocab": None, "clip_merges": None}
    if not models_dir:
        return out
    sd = os.path.join(models_dir, "stable-diffusion-inpainting")
    cn = os.path.join(models_dir, "control_v11p_sd15_inpaint")
    tok = os.path.join(models_dir, "clip-vit-large-patch14")
    weight_names = ("diffusion_pytorch_model.safetensors",
                    "diffusion_pytorch_model.bin")
    out["unet"] = _first_existing(
        *[os.path.join(sd, "unet", n) for n in weight_names])
    out["vae"] = _first_existing(
        *[os.path.join(sd, "vae", n) for n in weight_names])
    out["text"] = _first_existing(
        os.path.join(sd, "text_encoder", "model.safetensors"),
        os.path.join(sd, "text_encoder", "pytorch_model.bin"))
    out["controlnet"] = _first_existing(
        *[os.path.join(cn, n) for n in weight_names])
    out["clip_vocab"] = _first_existing(
        os.path.join(tok, "vocab.json"), os.path.join(models_dir, "vocab.json"))
    out["clip_merges"] = _first_existing(
        os.path.join(tok, "merges.txt"), os.path.join(models_dir, "merges.txt"))
    return out


def build_diffusion_models(cfg: PipelineConfig, device, dtype: torch.dtype,
                           seed: int = 0,
                           models_dir: Optional[str] = None) -> dict:
    """The CLIP text encoder, the UNet, the ControlNet and the VAE of
    ``cfg.diffusion``, each from its checkpoint under ``models_dir`` or
    with placeholder params, on ``device`` in ``dtype`` (the conv stacks
    channels-last)."""
    from inklayer_tpu_torch.models.diffusion import (
        AutoencoderKL, CLIPTextEncoder, ControlNet, UNet2DCondition)
    d = cfg.diffusion
    dev = resolve_device(device)
    ckpts = resolve_diffusion_checkpoints(models_dir)
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
        model = _params(model, name, ckpts[name], models_dir, seed + 3 + i,
                        weights.DIFFUSION_IGNORE)
        model = model.to(device=dev, dtype=dtype).eval()
        if name != "text":
            model = model.to(memory_format=torch.channels_last)
        models[name] = model
    return models


def build_inpainter(cfg: PipelineConfig, device="cuda",
                    dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, models_dir: Optional[str] = None
                    ) -> Inpainter:
    """The ControlNet-inpaint stage.  The diffusion models are built on
    first use (the reference's lazy singleton), once, however many threads
    ask at the same time; ``get_pipeline()`` returns the
    :class:`ControlNetInpaintPipeline`.  A CUDA device without a card
    raises here, not at first use."""
    from inklayer_tpu_torch.models.diffusion import (
        CLIPTokenizer, ControlNetInpaintPipeline)
    from inklayer_tpu_torch.pipeline.inpaint.prepost import (
        preprocess_image, preprocess_mask)
    resolve_device(device)
    state = {}
    lock = threading.Lock()

    def pipe():
        if "pipe" not in state:
            with lock:
                if "pipe" not in state:
                    ckpts = resolve_diffusion_checkpoints(models_dir)
                    p = ControlNetInpaintPipeline(
                        build_diffusion_models(cfg, device, dtype, seed,
                                               models_dir),
                        cfg.diffusion,
                        tokenizer=CLIPTokenizer(ckpts["clip_vocab"],
                                                ckpts["clip_merges"]))
                    state["fn"] = p.inpaint_fn()
                    state["batch_fn"] = p.inpaint_batch_fn()
                    state["pipe"] = p
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
                   vocab_path: Optional[str] = None,
                   models_dir: Optional[str] = None) -> InkLayerPipeline:
    """Detector, SAM predictor, depth estimator and inpainter on ``device``
    in ``dtype`` (bf16 on the card; LayerNorm, softmax and sampling
    statistics stay fp32), from the checkpoints under ``models_dir`` where
    they exist."""
    return InkLayerPipeline(
        build_detector(cfg, device, dtype, seed, vocab_path, models_dir),
        build_sam(cfg, device, dtype, seed, models_dir),
        build_depth(cfg, device, dtype, seed, models_dir), cfg,
        inpainter=build_inpainter(cfg, device, dtype, seed, models_dir))
