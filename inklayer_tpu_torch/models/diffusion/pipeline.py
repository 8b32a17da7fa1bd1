"""Stable Diffusion ControlNet inpainting pipeline (port of
:mod:`inklayer_tpu.models.diffusion.pipeline`).

What diffusers' StableDiffusionControlNetInpaintPipeline does for the
reference: 768^2, 30 DPM-Solver++(2M) steps, CFG 9.0, ControlNet
conditioning scale 1.2, seed 3, TWO passes, the second with the control
image rebuilt from the first pass's output.

The JAX package runs the whole 30-step loop inside one jit
(``lax.fori_loop``); here it is an eager Python loop over device tensors,
the solver coefficients precomputed on the host
(:func:`~inklayer_tpu_torch.models.diffusion.scheduler.solver_tables`).
Latents and the solver update stay fp32; the models run in their weights'
dtype.  Noise comes from a ``torch.Generator`` on the CPU seeded with the
seed (the JAX package draws ``jax.random.normal``, which torch cannot
reproduce; the tests inject the same noise into both).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from inklayer_tpu_torch.config import DiffusionConfig
from inklayer_tpu_torch.models.diffusion.clip_text import CLIPTokenizer
from inklayer_tpu_torch.models.diffusion.scheduler import (
    DPMSolverMultistepScheduler, solver_tables)
from inklayer_tpu_torch.pipeline.inpaint.prepost import (
    finalize_sketch, make_inpaint_condition, postprocess_result,
    preprocess_image, preprocess_mask)
from inklayer_tpu_torch.spans import span


def _nchw(arr: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, C) host array -> (B, C, H, W) fp32 channels-last tensor."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    return t.permute(0, 3, 1, 2)


def _to_uint8(out: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) in [0, 1] -> (B, H, W, 3) uint8 (NaN -> 0, truncating
    as the reference's cast does)."""
    arr = np.nan_to_num(out.permute(0, 2, 3, 1).float().cpu().numpy())
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


@contextlib.contextmanager
def stage(pipe, key: str):
    """``with stage(pipe, key):`` an ``inpaint.<key>`` span of a diffusion
    pipeline, ended by ``pipe._add_time(key, t0)``: a synchronise of the
    thread's stream and the stage's seconds added to ``pipe.stage_times``
    (``profiling.device_profile_stages`` splits a traced call there)."""
    t0 = time.perf_counter()
    with span("inpaint." + key):
        yield
        pipe._add_time(key, t0)


class ControlNetInpaintPipeline:
    """``models``: {'text', 'unet', 'controlnet', 'vae'} modules on one
    device, in one dtype."""

    # batch buckets of generate_batch; more layers run in ceil(B / 4)
    # launches of at most 4 (8 CFG samples of 768^2 UNet activations)
    BATCH_BUCKETS = (1, 2, 4)

    def __init__(self, models: dict, cfg: DiffusionConfig = DiffusionConfig(),
                 tokenizer: Optional[CLIPTokenizer] = None):
        self.cfg = cfg
        self.text_encoder = models["text"]
        self.unet = models["unet"]
        self.controlnet = models["controlnet"]
        self.vae = models["vae"]
        w = self.unet.conv_in.weight
        self.device, self.dtype = w.device, w.dtype
        self.tokenizer = tokenizer or CLIPTokenizer()
        self.scheduler = DPMSolverMultistepScheduler()
        self._text_cache = {}
        # seconds of the last generate / generate_batch call: encode, loop
        # (the solver steps; "steps" counts them), decode, prepost (the
        # host pre/post-processing of inpaint_fn / inpaint_batch_fn)
        self.stage_times: dict = {}

    def _sync(self) -> float:
        # the calling thread's stream, not the whole device: work that
        # other threads queued on their own streams need not finish
        if self.device.type == "cuda":
            with span("wait"):
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
    def encode_prompt(self, prompt: str, negative: str) -> torch.Tensor:
        """(2, text_maxlen, hidden) embeddings of [negative, prompt]."""
        key = (prompt, negative)
        if key not in self._text_cache:
            ids = np.concatenate([
                self.tokenizer.encode(negative, self.cfg.text_maxlen),
                self.tokenizer.encode(prompt, self.cfg.text_maxlen)])
            self._text_cache[key] = self.text_encoder(
                torch.from_numpy(ids).long().to(self.device))
        return self._text_cache[key]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _sample_batch(self, text_emb, images01, masks01, controls, noise,
                      tables, steps: int, guidance: float,
                      cond_scale: float) -> torch.Tensor:
        """B independent layers, one UNet/ControlNet launch per solver
        step; the CFG batch is [uncond x B, cond x B].

        images01 (B, 3, H, W) in [0, 1]; masks01 (B, 1, H, W); controls
        (B, 3, H, W) with masked pixels -1; noise (B, C_lat, H/8, W/8);
        tables from ``solver_tables``.  Returns (B, 3, H, W) in [0, 1]."""
        ts, a_t, s_t, c_sample, c_x0, c_d = (np.asarray(t) for t in tables)
        cl = torch.channels_last
        bsz = images01.shape[0]
        self._sync()
        with stage(self, "encode"):
            masked = (images01 * 2.0 - 1.0) * (masks01 < 0.5)
            masked_lat = self.vae.encode(masked.contiguous(memory_format=cl))
            lh, lw = masked_lat.shape[2:]
            # jax.image.resize "nearest" samples pixel centres:
            # nearest-exact
            mask_lat = F.interpolate(masks01, size=(lh, lw),
                                     mode="nearest-exact")
            extra = torch.cat([mask_lat.to(masked_lat.dtype), masked_lat],
                              dim=1)
            extra = torch.cat([extra, extra])
            emb = torch.cat([text_emb[0:1].expand(bsz, -1, -1),
                             text_emb[1:2].expand(bsz, -1, -1)])
            cond2 = torch.cat([controls, controls]).to(self.dtype) \
                .contiguous(memory_format=cl)

        with stage(self, "loop"):
            latents = noise.float()
            x0_prev = torch.zeros_like(latents)
            for i in range(steps):
                with span("inpaint.step"):
                    lat_in = torch.cat([latents, latents]).to(self.dtype)
                    t_in = torch.full((2 * bsz,), int(ts[i]),
                                      dtype=torch.int32, device=self.device)
                    down, mid = self.controlnet(
                        lat_in.contiguous(memory_format=cl), t_in, emb,
                        cond2, conditioning_scale=cond_scale)
                    nine = torch.cat([lat_in, extra], dim=1).contiguous(
                        memory_format=cl)
                    eps = self.unet(nine, t_in, emb, down_residuals=down,
                                    mid_residual=mid)
                    eps_u, eps_c = eps[:bsz], eps[bsz:]
                    eps = (eps_u + guidance * (eps_c - eps_u)).float()
                    x0 = (latents - float(s_t[i]) * eps) / float(a_t[i])
                    latents = (float(c_sample[i]) * latents
                               + float(c_x0[i]) * x0
                               + float(c_d[i]) * (x0 - x0_prev))
                    x0_prev = x0
            self.stage_times["steps"] = self.stage_times.get("steps", 0) \
                + steps
        with stage(self, "decode"):
            out = self.vae.decode(latents.contiguous(memory_format=cl))
            out = torch.clamp(out.float() * 0.5 + 0.5, 0.0, 1.0)
        return out

    def _sample(self, text_emb, image01, mask01, control_img, noise, tables,
                steps: int, guidance: float, cond_scale: float
                ) -> torch.Tensor:
        """One layer: image01 (3, H, W), mask01 (1, H, W), control_img
        (3, H, W), noise (1, C_lat, H/8, W/8) -> (3, H, W)."""
        return self._sample_batch(text_emb, image01[None], mask01[None],
                                  control_img[None], noise, tables, steps,
                                  guidance, cond_scale)[0]

    # ------------------------------------------------------------------
    def _settings(self, prompt, negative_prompt, guidance_scale, cond_scale,
                  steps, seed, num_passes):
        cfg = self.cfg
        pick = lambda v, d: d if v is None else v
        return (pick(prompt, cfg.prompt),
                pick(negative_prompt, cfg.negative_prompt),
                float(pick(guidance_scale, cfg.guidance_scale)),
                float(pick(cond_scale, cfg.controlnet_scale)),
                pick(steps, cfg.num_steps), pick(seed, cfg.seed),
                pick(num_passes, cfg.num_passes))

    def generate(self, image: Image.Image, mask: Image.Image,
                 prompt: Optional[str] = None,
                 negative_prompt: Optional[str] = None,
                 guidance_scale: Optional[float] = None,
                 cond_scale: Optional[float] = None,
                 steps: Optional[int] = None, seed: Optional[int] = None,
                 num_passes: Optional[int] = None) -> Image.Image:
        prompt, negative, guidance, cscale, steps, seed, passes = \
            self._settings(prompt, negative_prompt, guidance_scale,
                           cond_scale, steps, seed, num_passes)
        size = self.cfg.resolution
        self.stage_times = {}
        text_emb = self.encode_prompt(prompt, negative)
        tables = solver_tables(self.scheduler, steps)
        img_r = image.resize((size, size), Image.LANCZOS)
        mask_r = mask.resize((size, size), Image.LANCZOS)
        mask01 = np.asarray(mask_r.convert("L"), np.float32)[None, ..., None] \
            / 255.0
        noise = self.initial_noise(
            seed, (1, self.cfg.latent_channels, size // 8, size // 8))
        cur = img_r
        for _ in range(passes):
            control = make_inpaint_condition(cur, mask_r)
            img01 = np.asarray(cur.convert("RGB"), np.float32)[None] / 255.0
            out = self._sample_batch(
                text_emb, _nchw(img01, self.device),
                _nchw(mask01, self.device),
                _nchw(control[None], self.device), noise, tables, steps,
                guidance, cscale)
            cur = Image.fromarray(_to_uint8(out)[0])
        return cur

    def generate_batch(self, images, masks, prompt: Optional[str] = None,
                       negative_prompt: Optional[str] = None,
                       guidance_scale: Optional[float] = None,
                       cond_scale: Optional[float] = None,
                       steps: Optional[int] = None, seed: Optional[int] = None,
                       num_passes: Optional[int] = None):
        """B (image, mask) pairs -> B PIL images, sharing one
        UNet/ControlNet launch per solver step.  Equal to B independent
        ``generate`` calls: every layer gets the same seeded noise, and
        pass 2 rebuilds each layer's control image from its own pass-1
        output."""
        prompt, negative, guidance, cscale, steps, seed, passes = \
            self._settings(prompt, negative_prompt, guidance_scale,
                           cond_scale, steps, seed, num_passes)
        size = self.cfg.resolution
        n = len(images)
        if n == 0:
            return []
        self.stage_times = {}
        text_emb = self.encode_prompt(prompt, negative)
        tables = solver_tables(self.scheduler, steps)
        imgs_r = [im.resize((size, size), Image.LANCZOS) for im in images]
        masks_r = [mk.resize((size, size), Image.LANCZOS) for mk in masks]
        mask01 = np.stack([np.asarray(m.convert("L"), np.float32)[..., None]
                           / 255.0 for m in masks_r])
        noise1 = self.initial_noise(
            seed, (self.cfg.latent_channels, size // 8, size // 8))
        cap = self.BATCH_BUCKETS[-1]
        cur = list(imgs_r)
        for _ in range(passes):
            out_all = [None] * n
            for s in range(0, n, cap):
                idxs = list(range(s, min(n, s + cap)))
                bucket = next(x for x in self.BATCH_BUCKETS if x >= len(idxs))
                rows = idxs + [idxs[-1]] * (bucket - len(idxs))
                control = np.stack([make_inpaint_condition(cur[i], masks_r[i])
                                    for i in rows])
                img01 = np.stack([np.asarray(cur[i].convert("RGB"),
                                             np.float32) / 255.0
                                  for i in rows])
                out = self._sample_batch(
                    text_emb, _nchw(img01, self.device),
                    _nchw(mask01[rows], self.device),
                    _nchw(control, self.device),
                    noise1.expand(bucket, -1, -1, -1), tables, steps,
                    guidance, cscale)
                arr = _to_uint8(out)
                for k, i in enumerate(idxs):
                    out_all[i] = Image.fromarray(arr[k])
            cur = out_all
        return cur

    # ------------------------------------------------------------------
    def _finish(self, out: Image.Image, original: Image.Image,
                original_mask: Image.Image) -> Image.Image:
        out = out.resize(original.size, Image.LANCZOS)
        return finalize_sketch(postprocess_result(out, original,
                                                  original_mask))

    def inpaint_fn(self) -> Callable:
        """(image, mask) -> PIL: pre-processing, generate, resize back,
        post-processing and the final unsharp (the reference's
        ControlNet_inpaint)."""
        def fn(input_image: Image.Image, mask_image: Image.Image):
            t0 = time.perf_counter()
            with span("inpaint.prepost"):
                original, original_mask = (input_image.copy(),
                                           mask_image.copy())
                img = preprocess_image(input_image)
                msk = preprocess_mask(mask_image)
            pre = time.perf_counter() - t0
            out = self.generate(img, msk)
            t0 = time.perf_counter()
            with span("inpaint.prepost"):
                out = self._finish(out, original, original_mask)
            self.stage_times["prepost"] = pre + time.perf_counter() - t0
            return out

        return fn

    def inpaint_batch_fn(self) -> Callable:
        """Batched :meth:`inpaint_fn`: [(image, mask), ...] -> [PIL]."""
        def fn(pairs):
            t0 = time.perf_counter()
            with span("inpaint.prepost"):
                originals = [(im.copy(), mk.copy()) for im, mk in pairs]
                imgs = [preprocess_image(im) for im, _ in pairs]
                msks = [preprocess_mask(mk) for _, mk in pairs]
            pre = time.perf_counter() - t0
            outs = self.generate_batch(imgs, msks)
            t0 = time.perf_counter()
            with span("inpaint.prepost"):
                final = [self._finish(out, orig, orig_mask)
                         for out, (orig, orig_mask) in zip(outs, originals)]
            self.stage_times["prepost"] = pre + time.perf_counter() - t0
            return final

        return fn
