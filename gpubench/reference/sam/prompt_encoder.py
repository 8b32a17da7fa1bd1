"""Plain fp32 copy of ``inklayer_tpu_torch.models.sam.prompt_encoder`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.layers import LayerNorm


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (prompt_encoder.py:145-182)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        # a parameter, as in the JAX package's tree: training updates it
        # (the reference registers a buffer; the checkpoint key is the
        # same).  build.init_placeholder_params draws it after the other
        # parameters, where it drew the buffer, so the seeded placeholders
        # are unchanged
        gauss = nn.Parameter(torch.zeros(2, num_pos_feats))
        gauss.placeholder_last = True
        self.positional_encoding_gaussian_matrix = gauss

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1], (..., 2) -> (..., 2 * num_pos_feats), fp32."""
        c = 2.0 * coords.float() - 1.0
        c = c @ self.positional_encoding_gaussian_matrix.float()
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense PE over an (H, W) grid of pixel centres -> (H, W, C)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self(torch.stack([gx, gy], dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024)):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # neg point, pos point, box corner 1, box corner 2
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        # checkpoint keys mask_downscaling.{0,1,3,4,6} (the reference's
        # mask_in_chans = 16; 2 and 5 are the GELUs)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, kernel_size=2, stride=2), LayerNorm(4),
            nn.GELU(), nn.Conv2d(4, 16, kernel_size=2, stride=2),
            LayerNorm(16), nn.GELU(), nn.Conv2d(16, embed_dim, kernel_size=1))

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, embed_dim) PE of the embedding grid."""
        return self.pe_layer.grid(self.image_embedding_size)[None]

    def _embed_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """Model-space pixel coordinates (..., 2) -> PE, normalised by the
        input image size."""
        h, w = self.input_image_size
        return self.pe_layer(coords.float() / torch.tensor(
            [w, h], dtype=torch.float32, device=coords.device))

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
        """points: (B, N, 2) model-space pixel xy (the +0.5 pixel-centre
        shift is applied here); labels: (B, N), -1 pad, 0 negative, 1
        positive -> (B, N, embed_dim) fp32."""
        pe = self._embed_coords(points.float() + 0.5)
        pad = (labels == -1)[..., None]
        pe = torch.where(pad, 0.0, pe)
        for mask, emb in ((pad, self.not_a_point_embed),
                          ((labels == 0)[..., None], self.point_embeddings[0]),
                          ((labels == 1)[..., None], self.point_embeddings[1])):
            pe = pe + torch.where(mask, emb.weight.float(), 0.0)
        return pe

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes: (B, 4) xyxy model-space pixels -> (B, 2, embed_dim)."""
        pe = self._embed_coords(boxes.float().reshape(-1, 2, 2) + 0.5)
        return torch.stack([
            pe[:, 0] + self.point_embeddings[2].weight[0].float(),
            pe[:, 1] + self.point_embeddings[3].weight[0].float()], dim=1)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks: (B, 4H, 4W, 1) -> (B, H, W, embed_dim) in the model's
        dtype: conv 2x2/2 -> LN(4) -> GELU -> conv 2x2/2 -> LN(16) -> GELU
        -> conv 1x1; the convolutions on NCHW views, the norms on NHWC."""
        conv1, ln1, _, conv2, ln2, _, conv3 = self.mask_downscaling
        x = masks.to(conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.gelu(ln1(conv1(x).permute(0, 2, 3, 1)))
        x = F.gelu(ln2(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)))
        return conv3(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        """(batch, H, W, embed_dim): the no-mask embedding everywhere."""
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.embed_dim)

    def forward(self, boxes: Optional[torch.Tensor] = None,
                points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                masks: Optional[torch.Tensor] = None):
        """Returns (sparse (B, N, C) fp32, dense (B, H, W, C)).  ``points``
        is (coords (B, N, 2), labels (B, N)); the sparse prompts are the
        points' embeddings, then the boxes', as in the JAX package.  The
        batch is the number of prompts.  Boxes come first in the signature
        so that the box-only call ``prompt_encoder(boxes)`` stays; keyword
        calls read as the JAX package's."""
        parts = []
        batch = 1 if masks is None else masks.shape[0]
        if points is not None:
            batch = points[0].shape[0]
            parts.append(self.embed_points(*points))
        if boxes is not None:
            batch = boxes.shape[0]
            parts.append(self.embed_boxes(boxes))
        dev = self.no_mask_embed.weight.device
        sparse = (torch.cat(parts, dim=1) if parts else
                  torch.zeros(batch, 0, self.embed_dim, device=dev))
        dense = (self.embed_masks(masks) if masks is not None
                 else self.no_mask_dense(batch))
        return sparse, dense
