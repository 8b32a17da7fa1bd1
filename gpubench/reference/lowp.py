"""The control: the reference computed in fp8 (e4m3), the precision below
the configuration's bf16.

Every weight of two or more dimensions is rounded to fp8 with one scale
per tensor (its largest magnitude maps to 448, e4m3's largest finite
value), and so is the input of every ``nn.Linear``, ``nn.Conv2d`` and
``nn.ConvTranspose2d`` call; the arithmetic itself stays fp32.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 with a per-tensor scale, back in its dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn)
    return (q.float() / scale).to(t.dtype)


def _round_input(module, args):
    return (fp8(args[0]),) + tuple(args[1:])


@torch.no_grad()
def quantize_(model: nn.Module) -> nn.Module:
    """Round ``model``'s weights in place and its layers' inputs from now
    on; returns the model."""
    for p in model.parameters():
        if p.dim() >= 2:
            p.copy_(fp8(p))
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_pre_hook(_round_input)
    return model


def _bf16_out(module, args, out):
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return out.to(torch.bfloat16).to(out.dtype)
    return out


@torch.no_grad()
def bf16_activations_(model: nn.Module) -> nn.Module:
    """A witness, not the control: ``model``'s weights rounded to bf16 and
    every leaf module's output from now on (the activations a bf16 program
    stores), the arithmetic fp32; returns the model."""
    for p in model.parameters():
        p.copy_(p.to(torch.bfloat16).to(p.dtype))
    for m in model.modules():
        if not list(m.children()):
            m.register_forward_hook(_bf16_out)
    return model
