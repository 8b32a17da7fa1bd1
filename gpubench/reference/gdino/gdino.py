"""Plain fp32 copy of ``inklayer_tpu_torch.models.gdino.gdino`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.config import GDinoConfig
from gpubench.reference.gdino.bert import BertModel, subsentence_masks
from gpubench.reference.gdino.swin import SwinTransformer
from gpubench.reference.gdino.transformer import (GDinoTransformer,
                                                         contrastive_logits,
                                                         sine_pos_embed_hw)
from gpubench.reference.layers import (MLPBlock, group_norm_nhwc,
                                          resize_pad_mask)
from gpubench.reference.image import (pick_bucket, resize_scale,
                                          scale_pad_normalize)

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GDinoConfig = GDinoConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.bert = BertModel(c.bert)
        self.feat_map = nn.Linear(c.bert.hidden_size, c.hidden_dim)
        # reference key layout: backbone.0 is the Swin trunk
        self.backbone = nn.ModuleList([SwinTransformer(c.swin)])
        chans = [c.swin.embed_dim * 2 ** i for i in c.swin.out_indices]
        projs = [nn.Sequential(nn.Conv2d(ch, c.hidden_dim, 1),
                               nn.GroupNorm(32, c.hidden_dim))
                 for ch in chans]
        for _ in range(c.num_feature_levels - len(chans)):
            projs.append(nn.Sequential(
                nn.Conv2d(chans[-1], c.hidden_dim, 3, stride=2, padding=1),
                nn.GroupNorm(32, c.hidden_dim)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = GDinoTransformer(c)
        # shared across decoder layers (dec_pred_bbox_embed_share)
        self.bbox_embed = nn.ModuleList([MLPBlock(c.hidden_dim, c.hidden_dim,
                                                  4, 3)])

    @property
    def dtype(self) -> torch.dtype:
        return self.feat_map.weight.dtype

    def forward(self, image, pad_mask, input_ids, text_self_attn_mask,
                position_ids, select=None):
        """image (B, H, W, 3) normalised and padded; pad_mask (B, H, W) True
        = pad; input_ids / position_ids (B, Nt); text_self_attn_mask
        (B, Nt, Nt).  Returns (logits (B, nq, max_text_len) fp32, boxes
        (B, nq, 4) cxcywh in [0, 1])."""
        c = self.cfg
        dt = self.dtype
        tok_mask = input_ids != c.bert.pad_token_id
        text = self.feat_map(self.bert(input_ids, text_self_attn_mask,
                                       position_ids))
        feats = self.backbone[0](image.to(dt), pad_mask)
        srcs, masks = [], []
        for i, (feat, m) in enumerate(feats):
            conv, gn = self.input_proj[i]
            s = F.linear(feat, conv.weight.reshape(c.hidden_dim, -1), conv.bias)
            srcs.append(group_norm_nhwc(s, 32, gn.weight, gn.bias))
            masks.append(m)
        for conv, gn in list(self.input_proj)[len(feats):]:
            x = F.conv2d(feats[-1][0].permute(0, 3, 1, 2), conv.weight,
                         conv.bias, stride=2, padding=1).permute(0, 2, 3, 1)
            srcs.append(group_norm_nhwc(x, 32, gn.weight, gn.bias))
            masks.append(resize_pad_mask(pad_mask, (x.shape[1], x.shape[2])))
        poses = [sine_pos_embed_hw(m, c.hidden_dim // 2, c.pe_temperature_h,
                                   c.pe_temperature_w).to(dt) for m in masks]
        hs, boxes, memory_text = self.transformer(
            srcs, masks, poses, text, tok_mask, text_self_attn_mask,
            position_ids, self.bbox_embed[0], select)
        logits = contrastive_logits(hs, memory_text, tok_mask, c.max_text_len)
        return logits, boxes


def caption_tensors(ids, device):
    """The caption's (1, T) token ids, sub-sentence attention mask and
    position ids on ``device``, from the ids as a list."""
    ids = np.asarray([ids], np.int64)
    attn, pos = subsentence_masks(ids)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, attn, pos))


def preprocess(cfg: GDinoConfig, image: torch.Tensor):
    """(H, W, 3) uint8 -> (normalised padded bucket image, pad mask)."""
    h, w = image.shape[:2]
    bucket = pick_bucket(h, w, cfg.shape_buckets)
    scale = min(resize_scale((h, w), bucket, "shortest"),
                min(bucket[0] / h, bucket[1] / w))
    s32 = np.float32(scale)
    pre = scale_pad_normalize(image, (s32, s32), IMAGENET_MEAN,
                              IMAGENET_STD, bucket)
    vh, vw = int(round(h * scale)), int(round(w * scale))
    pad_mask = torch.ones(bucket, dtype=torch.bool, device=image.device)
    pad_mask[:vh, :vw] = False
    return pre, pad_mask


@torch.no_grad()
def detect(model: GroundingDINO, image: torch.Tensor, caption_ids,
           select=None):
    """One image's whole detection: (probabilities (nq, T), boxes (nq, 4)
    cxcywh in [0, 1]) of every query before the top-K, the two-stage
    scores of every proposal (S,) and the proposals decoded (nq,): the
    model's own top-K, or ``select`` where given."""
    pre, pad = preprocess(model.cfg, image)
    ids, attn, pos = caption_tensors(caption_ids, image.device)
    sel = None if select is None else torch.as_tensor(
        select, device=image.device)[None]
    logits, boxes = model(pre[None], pad[None], ids, attn, pos, sel)
    scores, idx = model.transformer.last_selection
    return (torch.sigmoid(logits[0].float()), boxes[0].float(),
            scores[0].float(), idx[0])
