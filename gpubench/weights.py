"""Seeded weights for a model, made on the device in one draw.

The schema (every parameter's name and shape, and which are the scale and
shift of a normalisation) comes from the reference's module tree, built on
the meta device; the program's model loads the same dictionary with
``load_state_dict(strict=True)``, so a renamed or reshaped parameter fails
the load instead of going unset.

Values: one ``torch.randn`` of all the model's elements in the serving
dtype from a ``torch.Generator`` on the device, cut into the parameters and
scaled by ``STD``; biases are 0, and normalisation shifts 0 and scales 1
or the configuration's ``norm_scale`` for the model.
(With random biases the depth head's last convolution is its bias alone,
and its ReLU left every depth map 0 on the H100.)  The same seed gives the
same values on the same device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

STD = 0.02


def _norm_params(model: nn.Module, scale: float) -> Dict[str, float]:
    """{parameter name: fill} for the scale (``scale``) and shift (0) of
    every LayerNorm- or GroupNorm-like module (by class name)."""
    fills = {}
    for prefix, m in model.named_modules():
        kind = type(m).__name__
        if kind in ("LayerNorm", "GroupNorm") and hasattr(m, "weight"):
            p = f"{prefix}." if prefix else ""
            fills[p + "weight"] = scale
            fills[p + "bias"] = 0.0
    return fills


def schema(make, norm_scale: float = 1.0) -> List[Tuple[str, tuple, object]]:
    """[(name, shape, fill or None)] of the module ``make()`` builds (built
    on the meta device: no memory, no initialisation)."""
    with torch.device("meta"):
        model = make()
    fills = _norm_params(model, norm_scale)
    return [(k, tuple(v.shape),
             fills.get(k, 0.0 if k.endswith("bias") else None))
            for k, v in model.state_dict().items()]


@torch.no_grad()
def seeded_state_dict(entries, seed: int, device, dtype) -> dict:
    """The state dict of ``entries`` (from :func:`schema`) drawn from
    ``seed`` on ``device`` in ``dtype``: views into one buffer."""
    total = sum(_numel(shape) for _, shape, _ in entries)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat.mul_(STD)
    out, at = {}, 0
    for name, shape, fill in entries:
        n = _numel(shape)
        t = flat[at: at + n].view(shape)
        if fill is not None:
            t.fill_(fill)
        out[name] = t
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def build(make, state: dict, device, dtype) -> nn.Module:
    """``make()`` on ``device`` in ``dtype`` without initialisation, with
    ``state`` loaded, in eval mode."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device).to(dtype)
    model.load_state_dict(state, strict=True)
    return model.eval()
