"""Distance fields and the geodesic label flood (port of
:mod:`inklayer_tpu.ops.distance`).

Fixed-iteration relaxations over the 8 neighbour shifts, in the JAX
package's order and float arithmetic: chamfer distance (64 iterations in
the watershed, 96 per mask in the box assignment) and the cost-ordered
label flood (256 iterations).  XLA fuses each iteration in
the JAX package; here they are plain eager PyTorch, so one iteration is
tens of small launches and a flood of 256 iterations thousands of them.
"""

from __future__ import annotations

import torch

_INF = 1e9

_SHIFTS8 = ((0, 1, 1.0), (0, -1, 1.0), (1, 0, 1.0), (-1, 0, 1.0),
            (1, 1, 1.41421356), (1, -1, 1.41421356),
            (-1, 1, 1.41421356), (-1, -1, 1.41421356))


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = x[..., y - dy, x - dx], ``fill`` where that falls
    outside (jnp.roll with the wrapped row / column overwritten)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def chamfer_distance(seeds: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Approximate euclidean distance to the nearest True pixel of
    ``seeds`` ((..., H, W) bool -> fp32, batched over the leading axes: the
    JAX package's ``masked_nearest_distance`` is this over a mask stack),
    exact up to ``iters`` steps; farther pixels saturate."""
    d = torch.where(seeds, 0.0, _INF).float()
    for _ in range(iters):
        for dy, dx, wgt in _SHIFTS8:
            d = torch.minimum(d, _shift(d, dy, dx, _INF) + wgt)
    return d


def label_flood(markers: torch.Tensor, cost: torch.Tensor,
                region: torch.Tensor, iters: int = 256) -> torch.Tensor:
    """Watershed-style expansion of ``markers`` ((H, W) int32, 0 =
    unlabeled) across ``region``: a pixel adopts the label of the
    neighbour on the cheapest accumulated path (step length + entry cost).
    Jacobi relaxation of multi-source Dijkstra."""
    seeded = markers > 0
    dist = torch.where(seeded, 0.0, _INF).float()
    lbl = markers
    entry = torch.clamp(cost, min=0.0)
    for _ in range(iters):
        best_d, best_l = dist, lbl
        for dy, dx, wgt in _SHIFTS8:
            nd = _shift(dist, dy, dx, _INF) + wgt + entry
            nl = _shift(lbl, dy, dx, 0)
            better = (nd < best_d) & region & (nl > 0)
            best_d = torch.where(better, nd, best_d)
            best_l = torch.where(better, nl, best_l)
        dist = torch.where(seeded, 0.0, best_d)
        lbl = torch.where(seeded, markers, best_l)
    return torch.where(region, lbl, 0)
