"""GroundingDINO's detect forward and its three heavy parts, timed apart on
the card (port of the JAX package's ``scripts/ablate_gdino.py``).

    python -m inklayer_tpu_torch.scripts.ablate_gdino [--iters 10]
        [--device cuda]

At the 800^2 bucket (``BUCKET``), ``GroundingDINO(GDinoConfig())`` with
every floating parameter 0.01 (``runtime.constant_model``, bf16 on the
card) on a seeded image and the caption "object ." (6 token slots):

* ``full``: the whole forward;
* ``swin``: the Swin-T trunk (``model.backbone[0]``);
* ``bert``: the text encoder (``model.bert``);
* ``transformer``: the 6 + 6 layer deformable encoder / decoder
  (``model.transformer``) on seeded 4-level features of the bucket's
  shapes.

For each: the p50 wall of ``--iters`` calls after ``WARM_CALLS`` (each ends
in a synchronise of the card), the device ms of one traced call, and the
FLOPs of one call counted over the plain versions
(``profiling.counted_flops``: products and attention; the deformable
sampling is not counted, ``profile_gdino_roofline.msda_flops`` gives it).
Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from inklayer_tpu_torch.config import GDinoConfig
from inklayer_tpu_torch.models.gdino import GroundingDINO
from inklayer_tpu_torch.models.gdino.bert import subsentence_masks
from inklayer_tpu_torch.models.gdino.transformer import sine_pos_embed_hw
from inklayer_tpu_torch.profiling import (counted_flops, emit, sync,
                                          time_call, wall_ms)
from inklayer_tpu_torch.runtime import (compute_dtype, constant_model,
                                        resolve_device)

CAPTION_IDS = [101, 4874, 1012, 102, 0, 0]  # "[CLS] object . [SEP]" + pad
BUCKET = 800  # the image side, the pipeline's first shape bucket
WARM_CALLS = 3  # untimed calls of each part before the timed ones


def level_shapes(cfg, bucket: int) -> list:
    """The (h, w) of each feature level at a bucket^2 image: strides 8, 16
    and 32 of the trunk, then stride-2 convolutions (800: 100, 50, 25,
    13)."""
    s = math.ceil(bucket / 8)
    shapes = []
    for _ in range(cfg.num_feature_levels):
        shapes.append((s, s))
        s = math.ceil(s / 2)
    return shapes


def text_inputs(ids, device) -> tuple:
    """(input ids, self-attention mask, position ids) of one caption."""
    ids = np.asarray([ids], np.int64)
    attn, pos = subsentence_masks(ids)
    return tuple(torch.from_numpy(np.asarray(a)).to(device)
                 for a in (ids, attn, pos))


def parts(model, bucket: int, ids=CAPTION_IDS) -> dict:
    """{part: function} of ``model`` on seeded inputs at the bucket."""
    cfg, dev, dt = model.cfg, model.feat_map.weight.device, model.dtype
    gen = torch.Generator().manual_seed(0)
    img = torch.randn((1, bucket, bucket, 3), generator=gen).to(dev, dt)
    pad = torch.zeros((1, bucket, bucket), dtype=torch.bool, device=dev)
    ids, attn, pos = text_inputs(ids, dev)
    shapes = level_shapes(cfg, bucket)
    srcs = [torch.randn((1, h, w, cfg.hidden_dim), generator=gen).to(dev, dt)
            for h, w in shapes]
    masks = [torch.zeros((1, h, w), dtype=torch.bool, device=dev)
             for h, w in shapes]
    poses = [sine_pos_embed_hw(m, cfg.hidden_dim // 2, cfg.pe_temperature_h,
                               cfg.pe_temperature_w).to(dt) for m in masks]
    text = torch.randn((1, ids.shape[1], cfg.hidden_dim),
                       generator=gen).to(dev, dt)
    tok_mask = ids != cfg.bert.pad_token_id
    return {
        "full": lambda: model(img, pad, ids, attn, pos),
        "swin": lambda: model.backbone[0](img, pad),
        "bert": lambda: model.bert(ids, attn, pos),
        "transformer": lambda: model.transformer(
            srcs, masks, poses, text, tok_mask, attn, pos,
            model.bbox_embed[0]),
    }


def time_part(fn, model, iters: int, warm: int) -> dict:
    """{'p50_ms', 'first_s', 'device_ms', 'traced_wall_ms', 'gflop'} of one
    part of ``model`` (device times on the card only)."""
    device = model.feat_map.weight.device

    @torch.inference_mode()
    def call():
        fn()
        sync(device)

    first_s = wall_ms(call, 1)[0] / 1e3
    wall_ms(call, warm)
    return {**time_call(call, iters, device), "first_s": first_s,
            "gflop": counted_flops(fn, model) / 1e9}


def main(argv=None, model=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if model is None:
        dev = resolve_device(args.device)
        model = constant_model(lambda: GroundingDINO(GDinoConfig()), dev,
                               compute_dtype(dev))
    dev = model.feat_map.weight.device
    rows = {name: time_part(fn, model, args.iters, WARM_CALLS)
            for name, fn in parts(model, BUCKET).items()}
    for name, r in rows.items():
        dev_ms = "" if r["device_ms"] is None else \
            f", device {r['device_ms']:.3f} ms"
        print(f"{name:12s} p50 {r['p50_ms']:9.3f} ms{dev_ms}, "
              f"{r['gflop']:.1f} GFLOP counted (first call "
              f"{r['first_s']:.2f} s)")
    return emit({"bucket": BUCKET, "iters": args.iters,
                 "parts": rows}, dev)


if __name__ == "__main__":
    main()
