"""The SAM ViT-H image encoder's top kernels by device time (port of the
JAX package's ``scripts/profile_sam.py``).

    python -m inklayer_tpu_torch.scripts.profile_sam [--depth 32]
        [--global-idx 7,15,23,31] [--iters 3] [--device cuda]

The encoder at full width (1280 wide, 16 heads, window 14, 1024^2) cut to
``--depth`` blocks, the global blocks of ``--global-idx`` below it, every
floating parameter 0.01 (``runtime.constant_model``, bf16 on the card), on
a seeded input: one first call, two warm ones, one timed; then ``--iters``
forwards traced as one (``profiling.device_profile``), and the 40 kernels
with the most device time, with the device total.  It replaces the JAX
script's ``summarize``, which parsed a perfetto file.  Prints one JSON
line last.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from inklayer_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from inklayer_tpu_torch.profiling import emit, print_top, sync, top_kernels
from inklayer_tpu_torch.runtime import (compute_dtype, constant_model,
                                        resolve_device)


def main(argv=None, model=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--global-idx", default="7,15,23,31")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if model is None:
        dev = resolve_device(args.device)
        gidx = tuple(i for i in (int(s) for s in args.global_idx.split(",")
                                 if s) if i < args.depth)
        model = constant_model(lambda: ImageEncoderViT(
            depth=args.depth, global_attn_indexes=gidx), dev,
            compute_dtype(dev))
    dev = model.pos_embed.device
    size = model.grid * model.patch_embed.patch_size
    x = torch.from_numpy(np.random.RandomState(0).randn(1, size, size, 3)
                         ).to(dev, model.pos_embed.dtype)

    @torch.inference_mode()
    def call():
        model(x)
        sync(dev)

    res = top_kernels(call, args.iters, 40, dev)
    print_top(res, args.iters)
    return emit({"depth": len(model.blocks), "iters": args.iters, **res},
                dev)


if __name__ == "__main__":
    main()
