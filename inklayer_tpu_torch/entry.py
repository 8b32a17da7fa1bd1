"""Single-card forward step of the flagship model (port of the JAX
package's ``__graft_entry__.entry``): SAM ViT-H's box-prompted
segmentation, the pipeline's hottest path.

    fn, (image, boxes) = entry()       # on the card, bf16
    low_res_logits, iou = fn(image, boxes)

Constant placeholder parameters (every floating parameter 0.01, as the
bench); the image is (1, 1024, 1024, 3) zeros in the layout ``Sam.forward``
takes, the prompts 8 boxes.  The multi-process dry run is
:mod:`inklayer_tpu_torch.parallel.dryrun`.
"""

from __future__ import annotations

import torch

from inklayer_tpu_torch.config import SamConfig
from inklayer_tpu_torch.models.sam import Sam
from inklayer_tpu_torch.runtime import (compute_dtype, constant_model,
                                        resolve_device)


def entry(device="cuda", cfg: SamConfig = SamConfig()):
    """(fn, example_args): ``fn(image, boxes)`` runs ``Sam.forward`` (encode
    then decode the boxes) on ``device`` (bf16 on the card, fp32
    elsewhere) and returns (low-res logits (8, 1, 256, 256), iou (8, 1)).
    ``cfg`` defaults to ViT-H."""
    dev = resolve_device(device)
    model = constant_model(lambda: Sam(cfg), dev, compute_dtype(dev))
    image = torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=dev)
    boxes = torch.zeros((8, 4), device=dev)

    @torch.inference_mode()
    def fn(image, boxes):
        return model(image, boxes)

    return fn, (image, boxes)
