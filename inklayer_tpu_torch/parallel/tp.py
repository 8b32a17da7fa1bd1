"""Head-parallel tensor parallelism (the tp axis of the mesh) with explicit
local shards.

The JAX rules (``inklayer_tpu.parallel.sharding``) shard the attention
``qkv`` and the MLP's first layer over their output features
(column-parallel) and ``proj`` and the MLP's second layer over their input
features (row-parallel); GSPMD inserts the sum.  Here each module that
holds heads keeps only its rank's heads as plain tensors
(``shard_tp``), so every kernel receives plain local tensors, and the
ranks exchange data by ``all_reduce`` alone:

* :func:`copy_to_tp` in front of a column-parallel layer: identity forward,
  the sum of the ranks' input gradients backward;
* :func:`reduce_from_tp` behind a row-parallel layer: the sum of the
  ranks' partial outputs forward, identity backward.  The row-parallel
  bias is added once, after the sum.

A fused ``qkv`` is split by head, not by row: rank r keeps the q, k and v
rows of heads [r h / tp, (r + 1) h / tp).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class TPGroup:
    """The tp process group of this rank, its rank in it and its size."""
    group: object
    rank: int
    size: int


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` (a new tensor), accumulated in fp32
    (bf16 partial products are summed before they are rounded)."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def shard_column(linear: nn.Linear, tp: TPGroup, groups: int = 1) -> dict:
    """Keep this rank's output features of ``linear`` (weight rows and
    bias): of each of ``groups`` equal blocks of rows (q, k, v for a fused
    qkv), the rank's 1/tp.  Returns the layout of the kept parameters,
    {name: (dim, groups)}, that :func:`gather_tp` undoes."""
    n = linear.out_features // groups
    if n % tp.size:
        raise ValueError(f"{n} output features per group do not split "
                         f"over tp={tp.size}")
    lo, hi = tp.rank * n // tp.size, (tp.rank + 1) * n // tp.size
    layout = {}
    for name in ("weight", "bias"):
        p = getattr(linear, name)
        if p is None:
            continue
        kept = p.detach().reshape(groups, n, -1)[:, lo:hi]
        setattr(linear, name, nn.Parameter(
            kept.reshape(groups * (hi - lo), *p.shape[1:]).clone(),
            requires_grad=p.requires_grad))
        layout[name] = (0, groups)
    linear.out_features = groups * (hi - lo)
    return layout


def shard_row(linear: nn.Linear, tp: TPGroup) -> dict:
    """Keep this rank's input features of ``linear`` (weight columns); the
    bias stays whole and is added once, after :func:`reduce_from_tp`."""
    k = linear.in_features
    if k % tp.size:
        raise ValueError(f"{k} input features do not split over "
                         f"tp={tp.size}")
    lo, hi = tp.rank * k // tp.size, (tp.rank + 1) * k // tp.size
    linear.weight = nn.Parameter(
        linear.weight.detach()[:, lo:hi].contiguous(),
        requires_grad=linear.weight.requires_grad)
    linear.in_features = hi - lo
    return {"weight": (1, 1)}


def prefixed(prefix: str, layout: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in layout.items()}


def gather_tp(local: torch.Tensor, dim: int, groups: int,
              tp: TPGroup) -> torch.Tensor:
    """The whole parameter from every rank's ``local`` shard of a
    :func:`shard_column` / :func:`shard_row` layout."""
    parts = [torch.empty_like(local) for _ in range(tp.size)]
    dist.all_gather(parts, local.contiguous(), group=tp.group)
    shape = local.shape
    split = lambda t: t.reshape(*shape[:dim], groups, shape[dim] // groups,
                                *shape[dim + 1:])
    whole = torch.cat([split(t) for t in parts], dim=dim + 1)
    return whole.reshape(*shape[:dim], groups * whole.shape[dim + 1],
                         *shape[dim + 1:])


def row_linear(x: torch.Tensor, linear: nn.Linear, tp) -> torch.Tensor:
    """A row-parallel ``linear``: the ranks' partial products summed, then
    the bias."""
    if tp is None:
        return linear(x)
    out = reduce_from_tp(nn.functional.linear(x, linear.weight), tp)
    return out if linear.bias is None else out + linear.bias
