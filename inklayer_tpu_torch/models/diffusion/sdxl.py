"""SDXL inpainting (port of :mod:`inklayer_tpu.models.diffusion.sdxl`).

The reference's alternative inpainting backend
(``inpainting/inpaint_SDXL.py:13-35``: diffusers/stable-diffusion-xl-1.0-
inpainting-0.1 at 1024^2, 20 steps, strength 0.99, the same prompt
template).  Published architecture: UNet block channels (320, 640, 1280)
with transformer depths (0, 2, 10), linear projections, head_dim 64,
context 2048 = CLIP-L's penultimate state (768) beside OpenCLIP-bigG's
(1280), and the "text_time" conditioning (the pooled bigG embedding, 1280,
and the sinusoids of 6 time-ids, 6 x 256, into an MLP added to the time
embedding).

As in the JAX package, the sampler is DPM-Solver++(2M) with the SD1.5
tables, both text towers read one tokenizer's ids (EOS padding), the VAE
keeps the 0.18215 latent scale, and ``x0_prev`` starts at 0 even when
``strength`` < 1 starts the loop at ``t_start`` > 0.  Noise comes from a
``torch.Generator`` on the CPU seeded with ``cfg.seed`` (the JAX package
draws ``jax.random.normal``; ``generate`` takes ``noise`` so that both
packages can be handed the same array).  The pipeline runs where its
models are: build them on the card (``inklayer_tpu_torch.build.
build_sdxl_models``), or pass CPU modules to run on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from inklayer_tpu_torch.models.diffusion.clip_text import (CLIPTokenizer,
                                                           _TextModel)
from inklayer_tpu_torch.models.diffusion.pipeline import _to_uint8
from inklayer_tpu_torch.models.diffusion.scheduler import (
    DPMSolverMultistepScheduler, solver_tables)
from inklayer_tpu_torch.models.diffusion.unet import UNet2DCondition
from inklayer_tpu_torch.models.diffusion.vae import AutoencoderKL


@dataclass(frozen=True)
class SDXLConfig:
    resolution: int = 1024
    num_steps: int = 20
    strength: float = 0.99
    guidance_scale: float = 7.5
    seed: int = 3
    block_channels: Tuple[int, ...] = (320, 640, 1280)
    transformer_layers: Tuple[int, ...] = (0, 2, 10)
    context_dim: int = 2048
    pooled_dim: int = 1280
    latent_channels: int = 4
    vae_channels: Tuple[int, ...] = (128, 256, 512, 512)
    text_l_hidden: int = 768
    text_g_hidden: int = 1280
    text_l_layers: int = 12
    text_g_layers: int = 32
    prompt: str = (
        "A complete clean black and white 2D line sketch drawing, "
        "high quality details, completed shapes")
    negative_prompt: str = (
        "photorealistic, color, shading, gradient, blurry, incomplete")


class CLIPTextTower(nn.Module):
    """A CLIP text transformer returning the penultimate hidden state (the
    input of its last layer, SDXL's convention) and, with ``pooled_proj``,
    the bias-free ``text_projection`` of the final LayerNorm's output at
    the first EOS token (the bigG tower's pooled embedding).  Parameters
    carry the transformers ``CLIPTextModel(WithProjection)`` names
    (``SDXL_TEXT_RULES``)."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 1280,
                 layers: int = 32, heads: int = 20, max_len: int = 77,
                 pooled_proj: int = 0, act: str = "quick_gelu"):
        super().__init__()
        self.text_model = _TextModel(vocab_size, hidden, layers, heads,
                                     max_len, act)
        if pooled_proj:
            self.text_projection = nn.Linear(hidden, pooled_proj, bias=False)

    def forward(self, input_ids: torch.Tensor):
        """(B, n) int -> ((B, n, hidden) penultimate state, (B, pooled_proj)
        pooled embedding or None)."""
        tm = self.text_model
        penultimate, last = tm.hidden_states(input_ids)
        if not hasattr(self, "text_projection"):
            return penultimate, None
        final = tm.final_layer_norm(last)
        eos_idx = (input_ids == CLIPTokenizer.EOS).to(torch.int32).argmax(1)
        eos = final[torch.arange(input_ids.shape[0], device=final.device),
                    eos_idx]
        return penultimate, self.text_projection(eos)


def build_sdxl_models(cfg: SDXLConfig = SDXLConfig()):
    """(unet, vae, text_l, text_g) of ``cfg``, with uninitialised params on
    the current default device (``inklayer_tpu_torch.build.
    build_sdxl_models`` fills them and moves them to a device)."""
    unet = UNet2DCondition(
        in_channels=9, block_channels=cfg.block_channels,
        transformer_layers=cfg.transformer_layers, linear_proj=True,
        head_dim=64, context_dim=cfg.context_dim,
        addition_embed_dim=256, addition_proj_dim=cfg.pooled_dim + 6 * 256)
    vae = AutoencoderKL(cfg.vae_channels, cfg.latent_channels)
    text_l = CLIPTextTower(hidden=cfg.text_l_hidden, layers=cfg.text_l_layers,
                           heads=max(1, cfg.text_l_hidden // 64))
    text_g = CLIPTextTower(hidden=cfg.text_g_hidden, layers=cfg.text_g_layers,
                           heads=max(1, cfg.text_g_hidden // 64),
                           pooled_proj=cfg.pooled_dim, act="gelu")
    return unet, vae, text_l, text_g


class SDXLInpaintPipeline:
    """``models``: {'unet', 'vae', 'text_l', 'text_g'} modules on one
    device, in one dtype."""

    def __init__(self, models: dict, cfg: SDXLConfig = SDXLConfig(),
                 tokenizer: Optional[CLIPTokenizer] = None):
        self.cfg = cfg
        self.unet = models["unet"]
        self.vae = models["vae"]
        self.text_l = models["text_l"]
        self.text_g = models["text_g"]
        w = self.unet.conv_in.weight
        self.device, self.dtype = w.device, w.dtype
        self.tokenizer = tokenizer or CLIPTokenizer()
        self.scheduler = DPMSolverMultistepScheduler()
        # seconds of the last generate: encode (the two VAE encodes), loop
        # (the solver steps; "steps" counts them), decode
        self.stage_times: dict = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _add_time(self, key: str, t0: float) -> float:
        t1 = self._sync()
        self.stage_times[key] = self.stage_times.get(key, 0.0) + (t1 - t0)
        return t1

    def initial_noise(self, seed: int, shape) -> torch.Tensor:
        """Standard normal latents from a CPU generator seeded with
        ``seed`` (the same numbers on any device), moved to the device."""
        gen = torch.Generator().manual_seed(int(seed))
        return torch.randn(tuple(shape), generator=gen).to(self.device)

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, negative: str):
        """[negative, prompt] -> (context (2, 77, 2048): the two towers'
        penultimate states side by side, pooled (2, 1280))."""
        ids = torch.from_numpy(np.concatenate([
            self.tokenizer.encode(negative),
            self.tokenizer.encode(prompt)])).long().to(self.device)
        pen_l, _ = self.text_l(ids)
        pen_g, pooled = self.text_g(ids)
        return torch.cat([pen_l, pen_g], dim=-1), pooled

    @torch.inference_mode()
    def sample(self, context, pooled, image01, mask01, noise, tables,
               time_ids, steps: int, guidance: float, t_start: int
               ) -> torch.Tensor:
        """image01 (1, 3, H, W) in [0, 1]; mask01 (1, 1, H, W); noise
        (1, C_lat, H/8, W/8); tables from ``solver_tables``; time_ids
        (2, 6) floats.  Steps ``t_start`` .. ``steps`` - 1 with CFG batch 2
        ([uncond, cond]).  Returns (3, H, W) in [0, 1]."""
        ts, a_t, s_t, c_sample, c_x0, c_d = (np.asarray(t) for t in tables)
        cl = torch.channels_last
        t0 = self._sync()
        img = image01 * 2.0 - 1.0
        masked = img * (mask01 < 0.5)
        masked_lat = self.vae.encode(masked.contiguous(memory_format=cl))
        image_lat = self.vae.encode(img.contiguous(memory_format=cl))
        lh, lw = masked_lat.shape[2:]
        # jax.image.resize "nearest" samples pixel centres: nearest-exact
        mask_lat = F.interpolate(mask01, size=(lh, lw), mode="nearest-exact")
        extra = torch.cat([mask_lat.to(masked_lat.dtype), masked_lat], dim=1)
        extra = torch.cat([extra, extra])
        # strength < 1: start from the noised image latents at t_start
        latents = (float(a_t[t_start]) * image_lat.float()
                   + float(s_t[t_start]) * noise.float())
        t0 = self._add_time("encode", t0)

        x0_prev = torch.zeros_like(latents)
        for idx in range(t_start, steps):
            lat_in = torch.cat([latents, latents]).to(self.dtype)
            t_in = torch.full((2,), int(ts[idx]), dtype=torch.int32,
                              device=self.device)
            nine = torch.cat([lat_in, extra], dim=1).contiguous(
                memory_format=cl)
            eps = self.unet(nine, t_in, context, pooled_text=pooled,
                            time_ids=time_ids)
            eps_u, eps_c = eps[0:1], eps[1:2]
            eps = (eps_u + guidance * (eps_c - eps_u)).float()
            x0 = (latents - float(s_t[idx]) * eps) / float(a_t[idx])
            latents = (float(c_sample[idx]) * latents + float(c_x0[idx]) * x0
                       + float(c_d[idx]) * (x0 - x0_prev))
            x0_prev = x0
        self.stage_times["steps"] = self.stage_times.get("steps", 0) \
            + steps - t_start
        t0 = self._add_time("loop", t0)
        out = self.vae.decode(latents.contiguous(memory_format=cl))
        out = torch.clamp(out[0].float() * 0.5 + 0.5, 0.0, 1.0)
        self._add_time("decode", t0)
        return out

    def generate(self, image: Image.Image, mask: Image.Image,
                 prompt: Optional[str] = None,
                 negative_prompt: Optional[str] = None,
                 noise: Optional[torch.Tensor] = None) -> Image.Image:
        """Inpaint ``image`` where ``mask`` is white; returns an image of
        ``image``'s size.  ``noise`` (1, C_lat, S/8, S/8) replaces the
        seeded draw."""
        cfg = self.cfg
        size = cfg.resolution
        prompt = prompt if prompt is not None else cfg.prompt
        negative = (negative_prompt if negative_prompt is not None
                    else cfg.negative_prompt)
        self.stage_times = {}
        context, pooled = self.encode_prompt(prompt, negative)
        tables = solver_tables(self.scheduler, cfg.num_steps)
        t_start = max(0, int(round(cfg.num_steps * (1 - cfg.strength))))
        img_r = image.resize((size, size), Image.LANCZOS)
        mask_r = mask.resize((size, size), Image.LANCZOS)
        img01 = np.asarray(img_r.convert("RGB"), np.float32) / 255.0
        mask01 = np.asarray(mask_r.convert("L"), np.float32)[..., None] \
            / 255.0
        if noise is None:
            noise = self.initial_noise(
                cfg.seed, (1, cfg.latent_channels, size // 8, size // 8))
        # SDXL time_ids: (orig_h, orig_w, crop_y, crop_x, target_h, target_w)
        time_ids = torch.tensor([[size, size, 0, 0, size, size]] * 2,
                                dtype=torch.float32, device=self.device)
        nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device).permute(2, 0, 1)[None]
        out = self.sample(context, pooled, nchw(img01), nchw(mask01),
                          noise.to(self.device), tables, time_ids,
                          cfg.num_steps, float(cfg.guidance_scale), t_start)
        arr = _to_uint8(out[None])[0]
        return Image.fromarray(arr).resize(image.size, Image.LANCZOS)
