"""Plain fp32 copy of ``inklayer_tpu_torch.models.sam.sam`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from gpubench.reference.config import SamConfig
from gpubench.reference.sam.image_encoder import ImageEncoderViT
from gpubench.reference.sam.mask_decoder import MaskDecoder
from gpubench.reference.sam.prompt_encoder import PromptEncoder
from gpubench.reference.image import (resize_batch, resize_scale,
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

    def decode(self, embedding: torch.Tensor, boxes=None, points=None,
               masks=None, multimask_output: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, G, G, C) embedding + N prompts (model-space xyxy ``boxes``
        (N, 4), ``points`` (coords (N, P, 2), labels (N, P)), low-res
        ``masks`` (N, 4G, 4G, 1)) -> (low-res logits (N, M, 4G, 4G) fp32,
        iou (N, M)); M = 3 with ``multimask_output``, else 1."""
        sparse, dense = self.prompt_encoder(boxes=boxes, points=points,
                                            masks=masks)
        image_pe = self.prompt_encoder.get_dense_pe()
        n = sparse.shape[0]
        emb = embedding.expand(n, *embedding.shape[1:]).to(self.dtype)
        return self.mask_decoder(emb, image_pe, sparse, dense,
                                 multimask_output)

    def decode_boxes(self, embedding: torch.Tensor, boxes: torch.Tensor,
                     multimask_output: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, G, G, C) embedding + (N, 4) model-space xyxy boxes ->
        (low-res logits (N, M, 4G, 4G) fp32, iou (N, M))."""
        return self.decode(embedding, boxes=boxes,
                           multimask_output=multimask_output)

    def forward(self, image: torch.Tensor, boxes: torch.Tensor):
        return self.decode_boxes(self.encode(image), boxes)


def preprocess(cfg: SamConfig, image: torch.Tensor):
    """ResizeLongestSide to the rounded target shape, normalised and
    padded; box coordinates then scale per axis by (nw / w, nh / h)."""
    h, w = image.shape[:2]
    s = resize_scale((h, w), (cfg.image_size, cfg.image_size), "longest")
    nh, nw = int(h * s + 0.5), int(w * s + 0.5)
    pre = scale_pad_normalize(
        image, (np.float32(nh / h), np.float32(nw / w)), cfg.pixel_mean,
        cfg.pixel_std, (cfg.image_size, cfg.image_size))
    meta = {"scale": np.asarray([nw / w, nh / h], np.float32),
            "orig_hw": (h, w), "input_hw": (nh, nw)}
    return pre, meta


@torch.no_grad()
def encode(model: Sam, image: torch.Tensor) -> dict:
    """One image's embedding and resize bookkeeping."""
    pre, meta = preprocess(model.cfg, image)
    return {"embedding": model.encode(pre[None]), **meta}


@torch.no_grad()
def masks_for_boxes(model: Sam, state: dict, boxes_xyxy: np.ndarray,
                    capacity: int):
    """(N, 4) xyxy boxes in input pixels -> ((N, H, W) fp32 mask logits at
    the input size, (N,) IoU predictions); the prompts padded with zero
    boxes to ``capacity``, doubled until they fit."""
    n = len(boxes_xyxy)
    while capacity < n:
        capacity *= 2
    padded = np.zeros((capacity, 4), np.float32)
    padded[:n] = np.asarray(boxes_xyxy, np.float32) * np.tile(
        state["scale"], 2)
    boxes = torch.from_numpy(padded).to(state["embedding"].device)
    low, iou = model.decode(state["embedding"], boxes)
    low, iou = low[:n, 0].float(), iou[:n, 0].float()
    size = model.cfg.image_size
    ih, iw = state["input_hw"]
    up = resize_batch(low, (size, size))
    return resize_batch(up[:, :ih, :iw].contiguous(), state["orig_hw"]), iou
