"""SAM prompt encoder, box prompts (port of
:mod:`inklayer_tpu.models.sam.prompt_encoder`).

Box prompts are the only prompts the pipeline sends.  Point and mask
prompts are not ported yet.  As in the JAX package, whose parameter tree
holds only what the box path uses, the mask-prompt convnet
(``mask_downscaling.*``) is absent; it comes with mask prompts.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (prompt_encoder.py:145-182)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

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

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, embed_dim) PE of the embedding grid."""
        return self.pe_layer.grid(self.image_embedding_size)[None]

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes: (B, 4) xyxy model-space pixels -> (B, 2, embed_dim)."""
        h, w = self.input_image_size
        corners = boxes.float().reshape(-1, 2, 2) + 0.5
        norm = corners / torch.tensor([w, h], dtype=torch.float32,
                                      device=boxes.device)
        pe = self.pe_layer(norm)
        return torch.stack([
            pe[:, 0] + self.point_embeddings[2].weight[0].float(),
            pe[:, 1] + self.point_embeddings[3].weight[0].float()], dim=1)

    def forward(self, boxes: torch.Tensor):
        """Returns (sparse (B, 2, C), dense (B, H, W, C)) for box prompts."""
        batch = boxes.shape[0]
        h, w = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.embed_dim)
        return self.embed_boxes(boxes), dense
