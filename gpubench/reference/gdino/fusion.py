"""Plain fp32 copy of ``inklayer_tpu_torch.models.gdino.fusion`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.layers import LayerNorm
from gpubench.reference.ops import (all_reduce_max, copy_to_tp, ffn, row_linear, sdpa)

_CLAMP = 50000.0


class MultiheadAttention(nn.Module):
    """Packed-projection attention with ``nn.MultiheadAttention``'s
    checkpoint names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.tp = None
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        """q (B, Nq, C), k/v (B, Nk, C); mask broadcastable to
        (B, heads, Nq, Nk), True = attend."""
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        b, nq, _ = q.shape

        def heads(y, w, bias):
            y = F.linear(copy_to_tp(y, self.tp), w, bias)
            return y.reshape(b, y.shape[1], self.num_heads, -1).transpose(1, 2)

        out = sdpa(heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv),
                   mask=mask)
        return row_linear(out.transpose(1, 2).reshape(b, nq, -1),
                          self.out_proj, self.tp)


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.tp = None
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v, l, attention_mask_l: Optional[torch.Tensor] = None,
                vision_pad_mask: Optional[torch.Tensor] = None):
        """v (B, Nv, v_dim), l (B, Nl, l_dim); attention_mask_l (B, Nl) True
        = real token; vision_pad_mask (B, Nv) True = padded position.
        Returns (delta_v, delta_l)."""
        b, nv, _ = v.shape
        nl = l.shape[1]
        hd = self.head_dim
        v, l = copy_to_tp(v, self.tp), copy_to_tp(l, self.tp)

        def heads(x, n):
            return x.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q = heads(self.v_proj(v) * hd ** -0.5, nv)
        k = heads(self.l_proj(l), nl)
        value_v = heads(self.values_v_proj(v), nv)
        value_l = heads(self.values_l_proj(l), nl)

        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits - all_reduce_max(logits.max(), self.tp)
        logits = logits.clamp(-_CLAMP, _CLAMP)

        logits_t = logits.transpose(-1, -2)  # (b, h, l, v)
        row_max = logits_t.max(dim=-1, keepdim=True).values
        logits_t = logits_t - row_max.detach()
        logits_t = logits_t.clamp(-_CLAMP, _CLAMP)
        if vision_pad_mask is not None:
            logits_t = logits_t.masked_fill(vision_pad_mask[:, None, None, :],
                                            float("-inf"))
        attn_l = torch.softmax(logits_t, dim=-1)
        if attention_mask_l is not None:
            logits = logits.masked_fill(~attention_mask_l[:, None, None, :],
                                        float("-inf"))
        attn_v = torch.softmax(logits, dim=-1)

        out_v = torch.matmul(attn_v.to(value_l.dtype), value_l)
        out_l = torch.matmul(attn_l.to(value_v.dtype), value_v)
        out_v = out_v.transpose(1, 2).reshape(b, nv, -1)
        out_l = out_l.transpose(1, 2).reshape(b, nl, -1)
        return (row_linear(out_v, self.out_v_proj, self.tp),
                row_linear(out_l, self.out_l_proj, self.tp))


class BiAttentionBlock(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.layer_norm_v = LayerNorm(v_dim)
        self.layer_norm_l = LayerNorm(l_dim)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), 1e-4))

    def forward(self, v, l, attention_mask_l=None, vision_pad_mask=None):
        # the residual base is the NORMALISED input (fuse_modules.py:287-293)
        vn = self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, attention_mask_l, vision_pad_mask)
        return vn + self.gamma_v * dv, ln + self.gamma_l * dl


class TextEnhancerLayer(nn.Module):
    """Post-norm encoder layer over text (transformer_vanilla.py)."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.tp = None

    def forward(self, x, pos, self_attn_mask: Optional[torch.Tensor] = None):
        qk = x + pos
        mask = None if self_attn_mask is None else self_attn_mask[:, None]
        x = self.norm1(x + self.self_attn(qk, qk, x, mask=mask))
        return self.norm2(x + ffn(x, self.linear1, self.linear2, self.tp))
