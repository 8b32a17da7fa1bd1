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
rows of heads [r h / tp, (r + 1) h / tp).  A per-head table (Swin's
relative-position bias, (rows, heads)) keeps the rank's columns
(:func:`shard_param` on dim 1).

A module whose head count tp does not divide stays whole on every rank
(:func:`splits`): it runs every head on every rank, as one process does.
This is the head-level reading of the JAX rules, which drop a mesh axis
that does not divide its dimension.  Swin-T's first stage has 3 heads, so
at tp = 2 its attention stays whole while stages 1-3 (6, 12, 24 heads)
split.  Hidden units of an MLP split wherever tp divides them.

A maximum that every rank must subtract alike (the fusion attention's
global max) is taken detached and reduced with :func:`all_reduce_max`.
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


def all_reduce_max(x: torch.Tensor, tp) -> torch.Tensor:
    """The element-wise maximum over the tp group of ``x``, detached (a
    constant: no gradient flows through it)."""
    x = x.detach()
    if tp is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=tp.group)
    return y


def splits(heads: int, tp) -> bool:
    """Whether a module of ``heads`` heads splits over ``tp`` (else it
    stays whole on every rank)."""
    return heads % tp.size == 0


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def shard_param(module: nn.Module, name: str, tp: TPGroup, dim: int = 0,
                groups: int = 1) -> dict:
    """Keep this rank's part of parameter ``name`` of ``module`` along
    ``dim``: of each of ``groups`` equal blocks (q, k, v of a fused
    projection), the rank's 1/tp.  Returns its layout, {name: (dim,
    groups)}, that :func:`gather_tp` undoes."""
    p = getattr(module, name)
    n = p.shape[dim] // groups
    if n % tp.size:
        raise ValueError(f"{name}: {n} entries per group on dim {dim} do "
                         f"not split over tp={tp.size}")
    lo, hi = tp.rank * n // tp.size, (tp.rank + 1) * n // tp.size
    kept = p.detach().unflatten(dim, (groups, n)).narrow(dim + 1, lo,
                                                         hi - lo)
    setattr(module, name, nn.Parameter(   # a copy: the whole is freed
        kept.flatten(dim, dim + 1).clone(
            memory_format=torch.contiguous_format),
        requires_grad=p.requires_grad))
    return {name: (dim, groups)}


def shard_column(linear: nn.Linear, tp: TPGroup, groups: int = 1) -> dict:
    """Keep this rank's output features of ``linear`` (weight rows and
    bias): of each of ``groups`` equal blocks of rows (q, k, v for a fused
    qkv), the rank's 1/tp."""
    layout = shard_param(linear, "weight", tp, 0, groups)
    if linear.bias is not None:
        layout.update(shard_param(linear, "bias", tp, 0, groups))
    linear.out_features = linear.weight.shape[0]
    return layout


def shard_row(linear: nn.Linear, tp: TPGroup) -> dict:
    """Keep this rank's input features of ``linear`` (weight columns); the
    bias stays whole and is added once, after :func:`reduce_from_tp`."""
    layout = shard_param(linear, "weight", tp, 1)
    linear.in_features = linear.weight.shape[1]
    return layout


def ffn(x: torch.Tensor, first: nn.Linear, second: nn.Linear, tp,
        act=nn.functional.relu) -> torch.Tensor:
    """``second(act(first(x)))`` with ``first`` column-parallel and
    ``second`` row-parallel (whole layers where ``tp`` is None)."""
    return row_linear(act(first(copy_to_tp(x, tp))), second, tp)


def shard_ffn(first: nn.Linear, second: nn.Linear, tp: TPGroup,
              names: tuple) -> dict:
    """A two-layer feed-forward's tp plan: ``first`` column-parallel,
    ``second`` row-parallel (their names in the layout: ``names``)."""
    return {**prefixed(names[0], shard_column(first, tp)),
            **prefixed(names[1], shard_row(second, tp))}


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
