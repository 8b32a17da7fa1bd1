"""GroundingDINO deformable encoder / decoder (port of
:mod:`inklayer_tpu.models.gdino.transformer`).

Encoder: fusion -> text enhancer -> deformable self-attention over the
flattened level rasters.  Two-stage: encoder proposals, top-900 selection.
Decoder: query self-attention -> text cross-attention -> deformable
cross-attention -> FFN, with iterative box refinement through the shared
``bbox_embed``.  Both deformable attentions call :func:`ms_deform_attn`,
which launches the ``ms_deform_attn`` kernel on the card.

Tensor parallelism (``shard_tp``, ``parallel/tp.py``): the deformable
attention keeps its rank's heads (``value_proj`` and the head-major rows
of ``sampling_offsets`` / ``attention_weights`` column-parallel,
``output_proj`` row-parallel; the softmax runs over one head's levels and
points, so the split is exact), and the kernel runs on the rank's heads;
each layer's FFN keeps its rank's hidden units.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.config import GDinoConfig
from inklayer_tpu_torch.models.gdino.fusion import (BiAttentionBlock,
                                                    MultiheadAttention,
                                                    TextEnhancerLayer)
from inklayer_tpu_torch.nn.layers import LayerNorm, MLPBlock
from inklayer_tpu_torch.ops.deformable import ms_deform_attn
from inklayer_tpu_torch.parallel.tp import (copy_to_tp, ffn, prefixed,
                                            row_linear, shard_column,
                                            shard_ffn, shard_row, splits)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def sine_pos_embed_hw(mask: torch.Tensor, num_pos_feats: int = 128,
                      temperature_h: float = 20.0,
                      temperature_w: float = 20.0) -> torch.Tensor:
    """PositionEmbeddingSineHW: mask (B, H, W) True = pad -> (B, H, W,
    2 * num_pos_feats), (pos_y, pos_x) order."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)

    def enc(e, temp):
        dim_t = temp ** (2 * torch.floor(i / 2) / num_pos_feats)
        p = e[..., None] / dim_t
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(*e.shape, num_pos_feats)

    return torch.cat([enc(y_embed, temperature_h), enc(x_embed, temperature_w)],
                     dim=-1)


def sine_embed_coords(coords: torch.Tensor, num_pos_feats: int = 128,
                      temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of box coords (..., K) in [0, 1] -> (..., K * F), the
    first two coordinates swapped (gen_sineembed_for_position)."""
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2 * torch.floor(i / 2) / num_pos_feats)
    p = coords[..., None] * (2 * math.pi) / dim_t
    emb = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                      dim=-1).reshape(*coords.shape, num_pos_feats)
    if coords.shape[-1] >= 2:
        parts = [emb[..., 1, :], emb[..., 0, :]] + [
            emb[..., k, :] for k in range(2, coords.shape[-1])]
        return torch.cat(parts, dim=-1)
    return emb.reshape(*coords.shape[:-1], -1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


# ---------------------------------------------------------------------------
# Deformable attention module
# ---------------------------------------------------------------------------


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.head_dim = d_model // n_heads
        self.tp = None
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def shard_tp(self, tp) -> dict:
        """Keep this rank's heads (``n_heads`` becomes the local count)."""
        if not splits(self.n_heads, tp):
            return {}
        self.tp = tp
        self.n_heads //= tp.size
        layout = {}
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            layout.update(prefixed(name, shard_column(getattr(self, name),
                                                      tp)))
        return {**layout,
                **prefixed("output_proj", shard_row(self.output_proj, tp))}

    def forward(self, query, reference_points, value,
                spatial_shapes: Tuple[Tuple[int, int], ...], value_mask=None):
        """query (B, Lq, C) with pos added; reference_points (B, Lq, L, 2|4)
        in sigmoid space; value (B, Lv, C); value_mask (B, Lv) True = pad."""
        b, lq, _ = query.shape
        lv = value.shape[1]
        h, l, p = self.n_heads, self.n_levels, self.n_points
        query = copy_to_tp(query, self.tp)
        v = self.value_proj(copy_to_tp(value, self.tp))
        if value_mask is not None:
            v = v.masked_fill(value_mask[..., None], 0.0)
        v = v.reshape(b, lv, h, self.head_dim).contiguous()
        offsets = self.sampling_offsets(query).reshape(b, lq, h, l, p, 2).float()
        attn = torch.softmax(
            self.attention_weights(query).reshape(b, lq, h, l * p).float(), -1
        ).reshape(b, lq, h, l, p)
        # the decoder's reference points carry a gradient (the refined boxes)
        ref = copy_to_tp(reference_points.float(), self.tp)
        if ref.shape[-1] == 2:
            normalizer = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes],
                                      dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] + \
                offsets / normalizer[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + \
                offsets / p * ref[:, :, None, :, None, 2:] * 0.5
        out = ms_deform_attn(v, spatial_shapes, loc.contiguous(),
                             attn.contiguous())
        return row_linear(out, self.output_proj, self.tp)


# ---------------------------------------------------------------------------
# Encoder / decoder layers
# ---------------------------------------------------------------------------


class DeformableEncoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        c = cfg
        self.self_attn = MSDeformAttn(c.hidden_dim, c.num_feature_levels,
                                      c.nheads, c.enc_n_points)
        self.norm1 = LayerNorm(c.hidden_dim)
        self.linear1 = nn.Linear(c.hidden_dim, c.dim_feedforward)
        self.linear2 = nn.Linear(c.dim_feedforward, c.hidden_dim)
        self.norm2 = LayerNorm(c.hidden_dim)
        self.tp = None

    def shard_tp(self, tp) -> dict:
        """The FFN's hidden units (the attention has its own plan)."""
        self.tp = tp
        return shard_ffn(self.linear1, self.linear2, tp,
                         ("linear1", "linear2"))

    def forward(self, src, pos, reference_points, spatial_shapes, pad_mask):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                              pad_mask)
        src = self.norm1(src + attn)
        return self.norm2(src + ffn(src, self.linear1, self.linear2, self.tp))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        c = cfg
        self.self_attn = MultiheadAttention(c.hidden_dim, c.nheads)
        self.norm2 = LayerNorm(c.hidden_dim)
        self.ca_text = MultiheadAttention(c.hidden_dim, c.nheads)
        self.catext_norm = LayerNorm(c.hidden_dim)
        self.cross_attn = MSDeformAttn(c.hidden_dim, c.num_feature_levels,
                                       c.nheads, c.dec_n_points)
        self.norm1 = LayerNorm(c.hidden_dim)
        self.linear1 = nn.Linear(c.hidden_dim, c.dim_feedforward)
        self.linear2 = nn.Linear(c.dim_feedforward, c.hidden_dim)
        self.norm3 = LayerNorm(c.hidden_dim)
        self.tp = None

    def shard_tp(self, tp) -> dict:
        """The FFN's hidden units (the attentions have their own plans)."""
        self.tp = tp
        return shard_ffn(self.linear1, self.linear2, tp,
                         ("linear1", "linear2"))

    def forward(self, tgt, query_pos, memory, spatial_shapes, pad_mask,
                reference_points, text, text_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        q = tgt + query_pos
        tgt = self.catext_norm(
            tgt + self.ca_text(q, text, text, mask=text_mask[:, None, None, :]))
        da = self.cross_attn(tgt + query_pos, reference_points, memory,
                             spatial_shapes, pad_mask)
        tgt = self.norm1(tgt + da)
        return self.norm3(tgt + ffn(tgt, self.linear1, self.linear2, self.tp))


# ---------------------------------------------------------------------------
# Full transformer
# ---------------------------------------------------------------------------


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor):
    """(B, sum HW, n_levels, 2) normalised centre grids scaled by the valid
    ratios (deformable encoder get_reference_points)."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        ref = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        denom = valid_ratios[:, lvl, :] * torch.tensor(
            [w, h], dtype=torch.float32, device=dev)
        refs.append(ref[None] / denom[:, None, :])
    ref = torch.cat(refs, 1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def compute_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level pad masks -> (B, n_levels, 2) [w_ratio, h_ratio]."""
    ratios = []
    for m in masks:
        not_m = (~m).float()
        valid_h = not_m[:, :, 0].sum(1).clamp(min=1.0)
        valid_w = not_m[:, 0, :].sum(1).clamp(min=1.0)
        ratios.append(torch.stack([valid_w / m.shape[2],
                                   valid_h / m.shape[1]], -1))
    return torch.stack(ratios, 1)


def gen_encoder_output_proposals(memory, pad_mask, spatial_shapes):
    """(masked memory (B, L, C), proposals (B, L, 4) in logit space, +inf
    at invalid positions)."""
    b = memory.shape[0]
    dev = memory.device
    proposals, offset = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        m = pad_mask[:, offset: offset + h * w].reshape(b, h, w)
        offset += h * w
        valid_h = (~m[:, :, 0]).float().sum(1)
        valid_w = (~m[:, 0, :]).float().sum(1)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None]
        scale = torch.stack([valid_w, valid_h], -1).reshape(b, 1, 1, 2)
        grid = (grid.expand(b, h, w, 2) + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * 2.0 ** lvl)
        proposals.append(torch.cat([grid, wh], -1).reshape(b, h * w, 4))
    props = torch.cat(proposals, 1)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    safe = props.clamp(1e-3, 1 - 1e-3)
    props_logit = torch.log(safe / (1 - safe))
    invalid = pad_mask[..., None] | ~valid
    props_logit = props_logit.masked_fill(invalid, float("inf"))
    mem = memory.masked_fill(invalid, 0.0)
    return mem, props_logit


def contrastive_logits(x, text, text_token_mask, max_text_len: int):
    """queries @ text^T in fp32, -inf at padded text, padded to
    max_text_len (ContrastiveEmbed)."""
    res = torch.matmul(x.float(), text.float().transpose(-1, -2))
    res = res.masked_fill(~text_token_mask[:, None, :], float("-inf"))
    pad = max_text_len - res.shape[-1]
    if pad > 0:
        res = F.pad(res, (0, pad), value=float("-inf"))
    return res[..., :max_text_len]


class EncoderStack(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        c = cfg
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(c.hidden_dim, c.hidden_dim, c.fusion_embed_dim,
                             c.fusion_nheads) for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(
            TextEnhancerLayer(c.hidden_dim, c.text_enhancer_nheads,
                              c.text_enhancer_ffn) for _ in range(c.enc_layers))
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(c) for _ in range(c.enc_layers))


class DecoderStack(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        c = cfg
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.dec_layers))
        self.norm = LayerNorm(c.hidden_dim)
        self.ref_point_head = MLPBlock(2 * c.hidden_dim, c.hidden_dim,
                                       c.hidden_dim, 2)


class GDinoTransformer(nn.Module):
    def __init__(self, cfg: GDinoConfig = GDinoConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels,
                                                    c.hidden_dim))
        self.encoder = EncoderStack(c)
        self.decoder = DecoderStack(c)
        self.enc_output = nn.Linear(c.hidden_dim, c.hidden_dim)
        self.enc_output_norm = LayerNorm(c.hidden_dim)
        self.enc_out_bbox_embed = MLPBlock(c.hidden_dim, c.hidden_dim, 4, 3)
        self.tgt_embed = nn.Embedding(c.num_queries, c.hidden_dim)

    def forward(self, srcs, masks, pos_embeds, text, text_token_mask,
                text_self_attn_mask, position_ids, bbox_embed: MLPBlock):
        """Per-level srcs / pos (B, H, W, C) and pad masks (B, H, W); text
        (B, Nt, C).  Returns (decoder output after dec_norm (B, nq, C),
        final boxes (B, nq, 4) cxcywh, encoded text (B, Nt, C))."""
        c = self.cfg
        b = srcs[0].shape[0]
        dt = srcs[0].dtype
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(b, -1, c.hidden_dim) for s in srcs], 1)
        mask_flat = torch.cat([m.reshape(b, -1) for m in masks], 1)
        pos_flat = torch.cat(
            [p.reshape(b, -1, c.hidden_dim) + self.level_embed[i].to(dt)
             for i, p in enumerate(pos_embeds)], 1)
        valid_ratios = compute_valid_ratios(masks)
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        pos_text = sine_embed_coords(position_ids[..., None].float(),
                                     num_pos_feats=c.hidden_dim).to(dt)

        memory, memory_text = src_flat, text
        enc = self.encoder
        for fusion, text_layer, layer in zip(enc.fusion_layers,
                                             enc.text_layers, enc.layers):
            memory, memory_text = fusion(memory, memory_text, text_token_mask,
                                         vision_pad_mask=mask_flat)
            memory_text = text_layer(memory_text, pos_text,
                                     text_self_attn_mask)
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes,
                           mask_flat)

        # two-stage: proposals from the encoder output, top num_queries
        out_mem, out_props = gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        out_mem = self.enc_output_norm(self.enc_output(out_mem))
        enc_logits = contrastive_logits(out_mem, memory_text, text_token_mask,
                                        c.max_text_len)
        enc_boxes_unsig = self.enc_out_bbox_embed(out_mem).float() + out_props
        topk_scores = enc_logits.masked_fill(
            ~torch.isfinite(enc_logits), float("-inf")).max(-1).values
        topk_scores = torch.nan_to_num(topk_scores, nan=float("-inf"))
        topk_idx = torch.topk(topk_scores, c.num_queries, dim=1).indices
        ref_unsig = torch.gather(enc_boxes_unsig, 1,
                                 topk_idx[..., None].expand(-1, -1, 4))
        ref = torch.sigmoid(ref_unsig)
        out = self.tgt_embed.weight[None].expand(b, -1, -1).to(dt)

        dec = self.decoder
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)  # (B, L, 4)
        for layer in dec.layers:
            ref_input = ref[:, :, None, :] * vr4[:, None, :, :]
            query_sine = sine_embed_coords(ref_input[:, :, 0, :],
                                           num_pos_feats=c.hidden_dim // 2)
            query_pos = dec.ref_point_head(query_sine.to(dt))
            out = layer(out, query_pos, memory, spatial_shapes, mask_flat,
                        ref_input, memory_text, text_token_mask)
            delta = bbox_embed(out).float()
            ref = torch.sigmoid(delta + inverse_sigmoid(ref))
        return dec.norm(out), ref, memory_text
