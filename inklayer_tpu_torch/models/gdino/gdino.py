"""GroundingDINO model + detector wrapper (port of
:mod:`inklayer_tpu.models.gdino.gdino`).

``GroundingDINO.forward``: BERT over the sub-sentence-masked caption ->
``feat_map`` -> Swin-T -> input projections (1x1 conv + GroupNorm, extra
3x3/2 level) -> deformable transformer -> contrastive logits and boxes.
``GDinoDetector`` adds tokenisation with a caption cache, shape buckets,
the fixed-capacity top-K, the box threshold and period-stripped labels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.config import GDinoConfig
from inklayer_tpu_torch.models.gdino.bert import BertModel, subsentence_masks
from inklayer_tpu_torch.models.gdino.swin import SwinTransformer
from inklayer_tpu_torch.models.gdino.tokenizer import WordPieceTokenizer
from inklayer_tpu_torch.models.gdino.transformer import (GDinoTransformer,
                                                         contrastive_logits,
                                                         sine_pos_embed_hw)
from inklayer_tpu_torch.nn.layers import (MLPBlock, group_norm_nhwc,
                                          resize_pad_mask)
from inklayer_tpu_torch.ops.bits import readback, to_host
from inklayer_tpu_torch.ops.image import (pick_bucket, resize_scale,
                                          scale_pad_normalize)
from inklayer_tpu_torch.spans import span

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
                position_ids):
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
            position_ids, self.bbox_embed[0])
        logits = contrastive_logits(hs, memory_text, tok_mask, c.max_text_len)
        return logits, boxes


def top_detections(logits: torch.Tensor, boxes: torch.Tensor, max_boxes: int):
    """(B, nq, T) logits + (B, nq, 4) boxes -> fixed-capacity top-K in
    sigmoid space: scores (B, K), boxes (B, K, 4), token probs (B, K, T),
    score-descending."""
    probs = torch.sigmoid(logits)
    scores = torch.where(torch.isfinite(logits), probs,
                         torch.zeros_like(probs)).max(-1).values
    top_scores, idx = torch.topk(scores, max_boxes, dim=1)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_probs = torch.gather(probs, 1,
                             idx[..., None].expand(-1, -1, probs.shape[-1]))
    return top_scores, top_boxes, top_probs


class GDinoDetector:
    """Tokenisation, shape bucketing, top-K and thresholding around a
    :class:`GroundingDINO` module (detector/gdino.py run_ft_dino_on_sketch)."""

    def __init__(self, model: GroundingDINO, vocab_path: Optional[str] = None):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = WordPieceTokenizer(vocab_path)
        self._text_cache = {}

    @property
    def device(self) -> torch.device:
        return self.model.feat_map.weight.device

    def _tokenize(self, caption: str):
        if caption not in self._text_cache:
            ids = np.asarray(
                [self.tokenizer.encode(caption, self.cfg.max_text_len)],
                np.int64)
            attn, pos = subsentence_masks(ids)
            dev = self.device
            self._text_cache[caption] = (
                torch.from_numpy(ids).to(dev), torch.from_numpy(attn).to(dev),
                torch.from_numpy(pos).to(dev))
        return self._text_cache[caption]

    def _caption(self, caption: Optional[str]) -> str:
        # GDINO captions are lowercased and end with '.' (util/inference.py)
        cap = (caption if caption is not None else self.cfg.caption)
        cap = cap.lower().strip()
        return cap if cap.endswith(".") else cap + "."

    def _preprocess(self, image: torch.Tensor):
        c = self.cfg
        h, w = image.shape[:2]
        bucket = pick_bucket(h, w, c.shape_buckets)
        scale = min(resize_scale((h, w), bucket, "shortest"),
                    min(bucket[0] / h, bucket[1] / w))
        s32 = np.float32(scale)
        pre = scale_pad_normalize(image, (s32, s32), IMAGENET_MEAN,
                                  IMAGENET_STD, bucket)
        vh, vw = int(round(h * scale)), int(round(w * scale))
        pad_mask = torch.ones(bucket, dtype=torch.bool, device=image.device)
        pad_mask[:vh, :vw] = False
        return bucket, pre, pad_mask

    def detect_device(self, image: torch.Tensor,
                      caption: Optional[str] = None,
                      box_threshold: Optional[float] = None):
        """Runs the forward and top-K.  Returns (finalize, scores (K,),
        boxes (K, 4) normalised cxcywh) with the tensors still on the
        device; ``finalize()`` reads them back and thresholds.  Top-K is
        score-sorted, so the detections above the threshold are a PREFIX
        of the device tensors (the runner chains SAM decode on them)."""
        parts, finalize_host, scores, boxes = self.detect_device_parts(
            image, caption, box_threshold)

        def finalize():
            return finalize_host(readback(parts)())

        return finalize, scores, boxes

    @torch.inference_mode()
    def detect_device_parts(self, image: torch.Tensor,
                            caption: Optional[str] = None,
                            box_threshold: Optional[float] = None):
        """The lowest-level detect (the JAX package's
        ``detect_dispatch_device_parts``): returns (parts, finalize_host,
        scores (K,), boxes (K, 4)), where ``parts`` is the device tuple
        (scores, boxes, token probabilities, token ids) that the caller
        reads back with its own other results
        (:func:`inklayer_tpu_torch.ops.bits.readback`) and
        ``finalize_host`` turns the host arrays into the :meth:`detect`
        dict.  The runner's device front reads the detection back together
        with the NMS front this way."""
        c = self.cfg
        cap = self._caption(caption)
        thresh = c.box_threshold if box_threshold is None else box_threshold
        with span("detect", images=1):
            with span("detect.preprocess"):
                _, pre, pad_mask = self._preprocess(image)
                ids, attn, pos = self._tokenize(cap)
            with span("detect.forward"):
                logits, boxes = self.model(pre[None], pad_mask[None], ids,
                                           attn, pos)
                scores, top_boxes, tok_probs = top_detections(
                    logits, boxes, c.max_boxes)
                # numpy holds no bf16: widen on the device, as the host
                # path did
                parts = (scores[0].float(), top_boxes[0].double(),
                         tok_probs[0].float(), ids[0])

        def finalize_host(host_parts):
            s, b, tl, i = host_parts
            return self._threshold(s, b, tl, i, cap, thresh)

        return parts, finalize_host, scores[0], top_boxes[0]

    @torch.inference_mode()
    def detect_batch(self, images, caption: Optional[str] = None,
                     box_threshold: Optional[float] = None) -> list:
        """Batched detection for directory sweeps: the (H, W, 3) uint8
        images are grouped by shape bucket and each group runs as ONE
        forward, with each image's own pad mask and the caption's tokens
        broadcast.  Returns :meth:`detect`-style dicts in input order."""
        c = self.cfg
        cap = self._caption(caption)
        thresh = c.box_threshold if box_threshold is None else box_threshold
        ids, attn, pos = self._tokenize(cap)
        with span("detect", images=len(images)) as sp:
            token_ids = to_host(ids[0])
            groups: dict = {}
            prepped = []
            with span("detect.preprocess"):
                for i, image in enumerate(images):
                    bucket, pre, pad = self._preprocess(image)
                    prepped.append((pre, pad))
                    groups.setdefault(bucket, []).append(i)
            results = [None] * len(images)
            for idxs in groups.values():
                b = len(idxs)

                def tile(t):
                    return t.expand(b, *t.shape[1:]).contiguous()

                with span("detect.forward"):
                    logits, boxes = self.model(
                        torch.stack([prepped[i][0] for i in idxs]),
                        torch.stack([prepped[i][1] for i in idxs]),
                        tile(ids), tile(attn), tile(pos))
                    scores, top_boxes, tok_probs = top_detections(
                        logits, boxes, c.max_boxes)
                    scores, top_boxes = scores.float(), top_boxes.double()
                    tok_probs = tok_probs.float()
                scores = to_host(scores)
                top_boxes = to_host(top_boxes)
                tok_probs = to_host(tok_probs)
                for j, i in enumerate(idxs):
                    results[i] = self._threshold(scores[j], top_boxes[j],
                                                 tok_probs[j], token_ids,
                                                 cap, thresh)
            sp.count(boxes=sum(len(r["boxes"]) for r in results))
        return results

    def detect(self, image: torch.Tensor, caption: Optional[str] = None,
               box_threshold: Optional[float] = None) -> dict:
        """(H, W, 3) uint8 image tensor -> dict with normalised cxcywh
        'boxes' (N, 4), 'scores' (N,), 'token_logits' (N, T), 'labels'."""
        return self.detect_device(image, caption, box_threshold)[0]()

    @span("detect.threshold")
    def _threshold(self, scores, boxes, tok_logits, token_ids, cap,
                   thresh: float) -> dict:
        keep = scores > thresh
        labels = [self.phrase_from_posmap(tok_logits[i], token_ids,
                                          self.cfg.text_threshold)
                  for i in np.nonzero(keep)[0]]
        return {"boxes": boxes[keep], "scores": scores[keep],
                "token_logits": tok_logits[keep], "labels": labels,
                "caption": cap}

    def phrase_from_posmap(self, token_probs: np.ndarray,
                           token_ids: np.ndarray,
                           text_threshold: float) -> str:
        """Decode tokens whose probability exceeds text_threshold, [CLS]
        masked, periods stripped (util/inference.py:89).  As in the
        reference, ``posmap[right_idx:]`` is not cleared."""
        n = len(token_ids)
        posmap = token_probs[:n] > text_threshold
        posmap[0] = False
        ids = [int(t) for t, p in zip(token_ids, posmap) if p]
        return self.tokenizer.decode(ids).replace(".", "")
