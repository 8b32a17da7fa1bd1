"""Sam module + box-prompted predictor (port of
:mod:`inklayer_tpu.models.sam.sam`).

The predictor keeps the JAX package's state API, which the runner uses:
``compute_image_state`` (preprocess + ViT encode), ``decode_lowres_state``
(box prompts -> 256^2 low-res logits) and ``masks_from_lowres`` (upsample,
crop, resize to the input size, threshold); for the batched sweep
``precompute_image_states`` (one encode of several images) and
``predict_device_state`` (host pixel boxes -> masks).  Resampling uses the
jax.image-exact weight matrices of :mod:`inklayer_tpu_torch.ops.image`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from inklayer_tpu_torch.config import SamConfig
from inklayer_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from inklayer_tpu_torch.models.sam.mask_decoder import MaskDecoder
from inklayer_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from inklayer_tpu_torch.ops.image import (resize_batch, resize_scale,
                                          scale_pad_normalize)


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig = SamConfig()):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.image_encoder = ImageEncoderViT(
            img_size=cfg.image_size, patch_size=cfg.patch_size,
            embed_dim=cfg.encoder_embed_dim, depth=cfg.encoder_depth,
            num_heads=cfg.encoder_num_heads, out_chans=cfg.prompt_embed_dim,
            window_size=cfg.encoder_window_size,
            global_attn_indexes=cfg.encoder_global_attn_indexes)
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg.prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(cfg.image_size, cfg.image_size))
        self.mask_decoder = MaskDecoder(transformer_dim=cfg.prompt_embed_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """Preprocessed (B, S, S, 3) -> (B, S/16, S/16, 256)."""
        return self.image_encoder(image.to(self.dtype))

    def decode_boxes(self, embedding: torch.Tensor, boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, G, G, C) embedding + (N, 4) model-space xyxy boxes ->
        (low-res logits (N, 1, 4G, 4G) fp32, iou (N, 1))."""
        sparse, dense = self.prompt_encoder(boxes)
        image_pe = self.prompt_encoder.get_dense_pe()
        n = boxes.shape[0]
        emb = embedding.expand(n, *embedding.shape[1:]).to(self.dtype)
        return self.mask_decoder(emb, image_pe, sparse, dense)

    def forward(self, image: torch.Tensor, boxes: torch.Tensor):
        return self.decode_boxes(self.encode(image), boxes)


class SamPredictor:
    """Box-prompted predictor over a :class:`Sam` module.

    ``encode_fn`` overrides the image-encoder call: it takes the
    preprocessed (S, S, 3) image and returns its (G, G, C) embedding.
    Serving sets it to a micro-batched encoder
    (:class:`inklayer_tpu_torch.serve.batcher.BatchedSamEncoder`), so that
    concurrent requests share one batched ViT launch."""

    def __init__(self, model: Sam, box_capacity: int = 64, encode_fn=None):
        self.model = model
        self.cfg = model.cfg
        self.box_capacity = box_capacity
        self.encode_fn = encode_fn

    @property
    def device(self) -> torch.device:
        return self.model.image_encoder.pos_embed.device

    def _preprocess_meta(self, image: torch.Tensor):
        """ResizeLongestSide to the ROUNDED target shape; box coordinates
        then scale per axis by (nw / w, nh / h) (utils/transforms.py)."""
        c = self.cfg
        h, w = image.shape[:2]
        s = resize_scale((h, w), (c.image_size, c.image_size), "longest")
        nh, nw = int(h * s + 0.5), int(w * s + 0.5)
        pre = scale_pad_normalize(
            image, (np.float32(nh / h), np.float32(nw / w)), c.pixel_mean,
            c.pixel_std, (c.image_size, c.image_size))
        meta = {"scale": np.asarray([nw / w, nh / h], np.float32),
                "orig_hw": (h, w), "input_hw": (nh, nw)}
        return pre, meta

    @torch.inference_mode()
    def compute_image_state(self, image: torch.Tensor) -> dict:
        """(H, W, 3) uint8 image on the model's device -> state dict with
        the (1, G, G, C) embedding and the resize bookkeeping."""
        pre, meta = self._preprocess_meta(image)
        if self.encode_fn is not None:
            emb = self.encode_fn(pre)[None]
        else:
            emb = self.model.encode(pre[None])
        return {"embedding": emb, **meta}

    @torch.inference_mode()
    def precompute_image_states(self, images) -> list:
        """ONE batched ViT encode of several (H, W, 3) uint8 images on the
        model's device; returns one state per image, as
        :meth:`compute_image_state` does for one."""
        pres, metas = [], []
        for image in images:
            pre, meta = self._preprocess_meta(image)
            pres.append(pre)
            metas.append(meta)
        embs = self.model.encode(torch.stack(pres))
        return [{"embedding": embs[i: i + 1], **metas[i]}
                for i in range(len(images))]

    @torch.inference_mode()
    def predict_device_state(self, state: dict, boxes_xyxy):
        """(N, 4) xyxy boxes in input pixels (host) -> ((N, H, W) bool masks
        on the device, (N,) host iou).  The prompts are padded to
        ``box_capacity``, doubled until they fit, so the decoder sees the
        shapes of the chained path."""
        n = boxes_xyxy.shape[0]
        cap = self.box_capacity
        while cap < n:
            cap *= 2
        padded = np.zeros((cap, 4), np.float32)
        padded[:n] = (np.asarray(boxes_xyxy, np.float32)
                      * np.tile(state["scale"], 2))
        logits, iou = self.model.decode_boxes(
            state["embedding"], torch.from_numpy(padded).to(self.device))
        full = self._postprocess_device_state(state, logits[:n, 0])
        return (full > self.cfg.mask_threshold,
                iou[:n, 0].float().cpu().numpy())

    def _postprocess_device_state(self, state: dict, low_res_logits):
        """(n, 4G, 4G) logits -> (n, H, W) fp32 logits: upsample to the
        model size, crop the valid region, resize to the input size."""
        size = self.cfg.image_size
        ih, iw = state["input_hw"]
        up = resize_batch(low_res_logits.float(), (size, size))
        return resize_batch(up[:, :ih, :iw].contiguous(), state["orig_hw"])

    @torch.inference_mode()
    def decode_lowres_state(self, state: dict, boxes_model: torch.Tensor):
        """(cap, 4) boxes in model space -> ((cap, 4G, 4G) low-res logits,
        (cap,) iou)."""
        logits, iou = self.model.decode_boxes(state["embedding"], boxes_model)
        return logits[:, 0], iou[:, 0]

    @torch.inference_mode()
    def masks_from_lowres(self, state: dict, lowres: torch.Tensor,
                          n: int) -> torch.Tensor:
        """(cap, 4G, 4G) logits -> (n, H, W) bool masks for the first n
        prompts.  n is bucketed up to a power of two (capped at cap), as in
        the JAX package, then sliced."""
        cap = lowres.shape[0]
        b = 1
        while b < n:
            b *= 2
        b = min(b, cap)
        full = self._postprocess_device_state(state, lowres[:b])
        return (full > self.cfg.mask_threshold)[:n]
