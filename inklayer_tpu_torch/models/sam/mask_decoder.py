"""SAM mask decoder: TwoWayTransformer + hypernetwork heads (port of
:mod:`inklayer_tpu.models.sam.mask_decoder`).  A handful of tokens against
4096 image tokens: plain PyTorch, as the JAX package leaves it to XLA.

Tensor parallelism (:meth:`AttentionDS.shard_tp`, ``parallel/tp.py``):
each attention keeps its rank's heads (``q/k/v_proj`` column-parallel,
``out_proj`` row-parallel); the two-way blocks' MLPs stay whole, as the
JAX rules have no rule for them."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.nn.layers import MLP, LayerNorm, MLPBlock
from inklayer_tpu_torch.ops.attention import sdpa
from inklayer_tpu_torch.parallel.tp import (copy_to_tp, prefixed,
                                            row_linear, shard_column,
                                            shard_row, splits)


class AttentionDS(nn.Module):
    """Attention with an internal downsampled width
    (transformer.py:153-197)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.tp = None
        self.q_proj = nn.Linear(embed_dim, internal)
        self.k_proj = nn.Linear(embed_dim, internal)
        self.v_proj = nn.Linear(embed_dim, internal)
        self.out_proj = nn.Linear(internal, embed_dim)

    def shard_tp(self, tp) -> dict:
        """Keep this rank's heads (``num_heads`` becomes the local count)."""
        if not splits(self.num_heads, tp):
            return {}
        self.tp = tp
        self.num_heads //= tp.size
        layout = {}
        for name in ("q_proj", "k_proj", "v_proj"):
            layout.update(prefixed(name, shard_column(getattr(self, name),
                                                      tp)))
        return {**layout,
                **prefixed("out_proj", shard_row(self.out_proj, tp))}

    def forward(self, q, k, v):
        def split(x, proj):
            x = proj(copy_to_tp(x, self.tp))
            b, n, c = x.shape
            return x.reshape(b, n, self.num_heads, c // self.num_heads
                             ).transpose(1, 2)

        out = sdpa(split(q, self.q_proj), split(k, self.k_proj),
                   split(v, self.v_proj))
        b, h, n, d = out.shape
        return row_linear(out.transpose(1, 2).reshape(b, n, h * d),
                          self.out_proj, self.tp)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = AttentionDS(embed_dim, num_heads)
        self.norm1 = LayerNorm(embed_dim)
        self.cross_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2)
        self.norm2 = LayerNorm(embed_dim)
        self.mlp = MLP(embed_dim, mlp_dim, embed_dim, act="relu")
        self.norm3 = LayerNorm(embed_dim)
        self.norm4 = LayerNorm(embed_dim)
        self.cross_attn_image_to_token = AttentionDS(embed_dim, num_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2)
        self.norm_final_attn = LayerNorm(embed_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, H, W, C), image_pe (1, H, W, C),
        point_embedding (B, N, C)."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(1, h * w, c).expand(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(kernel 2, stride 2) on NHWC: out[2i+a, 2j+b] =
    x[i, j] @ weight[:, :, a, b] + bias."""
    b, h, w, _ = x.shape
    o = weight.shape[1]
    y = torch.einsum("bhwc,coij->bhiwjo", x, weight.to(x.dtype))
    return y.reshape(b, 2 * h, 2 * w, o) + bias.to(x.dtype)


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3):
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        c = transformer_dim
        self.transformer = TwoWayTransformer(embed_dim=c, mlp_dim=8 * c)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        # checkpoint keys output_upscaling.0/.1/.3 (2 and 4 are GELUs)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2), LayerNorm(c // 4), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPBlock(c, c, c // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLPBlock(c, c, self.num_mask_tokens,
                                            iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, C) embeddings -> (masks (B, M, 4H, 4W) fp32 logits,
        iou_pred (B, M)): the single mask (M = 1), or with
        ``multimask_output`` the other three (M = 3)."""
        b = sparse_prompt_embeddings.shape[0]
        dt = image_embeddings.dtype
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1).to(dt),
                            sparse_prompt_embeddings.to(dt)], dim=1)
        src = image_embeddings + dense_prompt_embeddings.to(dt)
        hs, src = self.transformer(src, image_pe.to(dt), tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1: 1 + self.num_mask_tokens]

        h, w = image_embeddings.shape[1:3]
        up1, ln, _, up2, _ = self.output_upscaling
        x = src.reshape(b, h, w, -1)
        x = F.gelu(ln(conv_transpose_2x2(x, up1.weight, up1.bias)))
        upscaled = F.gelu(conv_transpose_2x2(x, up2.weight, up2.bias))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper_in.float(),
                             upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, 0:1], iou_pred[:, 0:1]
