"""Model export (port of :mod:`inklayer_tpu.io.export`; the reference ships
a SAM decoder ONNX exporter, segment-anything utils/onnx.py).

``torch.export`` captures a module's forward at the example argument
shapes as an ``ExportedProgram``, saved as a ``.pt2`` file that loads and
runs without the port's model code.  Export follows the device rule of
:mod:`runtime`, as the JAX package's export follows ``pallas_enabled()``:
traced on the card, a kernel the forward launches is recorded as its
custom op (``ops/norm.py``'s ``inklayer::layernorm_2d``, the one kernel
the SAM decoder reaches), which launches it when the program runs on the
card and runs the plain version on the CPU; traced on the CPU, the program
holds the plain versions.  Loading a program that holds the custom ops
needs the port imported (this module imports ``ops.norm``).
"""

from __future__ import annotations

import io
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from inklayer_tpu_torch.models.sam import Sam
from inklayer_tpu_torch.ops import norm  # noqa: F401  registers inklayer::*


def export_fn(module: nn.Module, example_args: Sequence[torch.Tensor],
              path: Optional[str] = None
              ) -> Tuple[torch.export.ExportedProgram, bytes]:
    """Export ``module``'s forward at the example argument shapes; return
    the program and its serialized bytes, also written to ``path`` when
    given."""
    with torch.no_grad():
        exported = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return exported, blob


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The program saved by :func:`export_fn`; call ``.module()(*args)``
    (on the device it was exported for)."""
    return torch.export.load(path)


class SamBoxDecoder(nn.Module):
    """SAM's prompt encoder + mask decoder as one function of (embedding,
    boxes): :meth:`Sam.decode_boxes`, run on a module that holds only
    those two parts (the image encoder's weights stay out of the
    program)."""

    decode = Sam.decode  # what Sam.decode_boxes calls on its self

    def __init__(self, sam: Sam):
        super().__init__()
        self.prompt_encoder = sam.prompt_encoder
        self.mask_decoder = sam.mask_decoder
        self.dtype = sam.dtype

    def forward(self, embedding: torch.Tensor, boxes: torch.Tensor):
        return Sam.decode_boxes(self, embedding, boxes)


def export_sam_decoder(model: Sam, cfg, path: Optional[str] = None,
                       box_capacity: int = 16):
    """Export the SAM prompt encoder + mask decoder (the part the reference
    exports to ONNX) at (1, G, G, C) embeddings and (box_capacity, 4)
    boxes, in the model's dtype and on its device."""
    grid = cfg.image_size // cfg.patch_size
    p = next(model.parameters())
    example = (
        torch.zeros((1, grid, grid, cfg.prompt_embed_dim), dtype=p.dtype,
                    device=p.device),
        torch.zeros((box_capacity, 4), dtype=torch.float32, device=p.device),
    )
    return export_fn(SamBoxDecoder(model).eval(), example, path)
