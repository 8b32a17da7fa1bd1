"""3x3 convolution, stride 1, same padding, NHWC, no bias (port of the
measurement prototype ``scripts/ablate_pallas_conv.py``, whose Pallas
kernels ``make_pallas_conv`` and ``make_pallas_conv_concat`` compute it).

The layouts are the JAX ones at the interface: input (B, H, W, C) and
weights (3, 3, C, Cout), HWIO, as the prototype's ``run(x, w)`` takes them.
On a CUDA tensor :func:`conv3x3_nhwc` launches the implicit-GEMM kernel of
``csrc/conv3x3.cu`` (bf16 in, fp32 sums, bf16 out) with the launch
configuration of :func:`conv_config`; on a CPU tensor it runs
:func:`conv3x3_nhwc_plain`, the prototype's shift-9 formulation.  No model
of the port calls it: the JAX package's UNet, ControlNet and VAE convolve
with XLA, so the port's keep ``F.conv2d``.  Its entry point is
``scripts/torch_conv_ab.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

CONV_PATCH_ROWS = 64  # output pixels per consumer warpgroup: one wgmma M
CONV_SLAB = 64  # channels per K slab: one 128-byte swizzle row
CONV_BLOCK_N = (256, 192, 128, 64)  # the instances of csrc/conv3x3.cu
CONV_MAX_SPLITS = 16

# The cost model of conv_config, in SM clocks of an H100: a slab of a
# 128 x BN tile takes 128 * BN * 64 / 2048 = 4 BN clocks of bf16 tensor
# work (2048 products per clock per SM), or its bytes (16 KB of image, BN
# x 128 of weights) at ~40 bytes per clock from L2, whichever is longer.
# Splits add their fp32 partial tiles (written, read back) and a bf16 pass
# at the HBM rate, 3.35 TB/s / 1.755 GHz ~ 1909 bytes per clock, and a
# second launch (~2 us).
_TENSOR_CLK_PER_N = 4
_L2_BYTES_PER_CLK = 40
_HBM_BYTES_PER_CLK = 1909
_REDUCE_LAUNCH_CLK = 3500


class ConvConfig(NamedTuple):
    """The launch configuration of the convolution kernel.

    A consumer warpgroup computes a patch of ``bh`` x ``bw`` output pixels
    (at most 64: its wgmma's 64 rows) of one image; patches are numbered
    image, then patch row, then patch column, ``patches_y`` x
    ``patches_x`` per image.  A 128-row M tile is patches 2i and 2i + 1; a
    tile is (M tile, N tile of ``bn`` columns), numbered M tile fastest.
    K = 9C runs in ``n_slabs`` slabs of one tap x 64 channels.  The first
    ``full`` tiles run whole, one unit each; each of the ``tail`` tiles
    after them is cut into ``splits`` contiguous slab ranges
    (:func:`split_range`), one unit each (:func:`unit_work`).  ``grid``
    persistent blocks take units ``block``, ``block + grid``, ...
    """

    bh: int
    bw: int
    patches_y: int
    patches_x: int
    patches: int
    m_tiles: int
    bn: int
    n_tiles: int
    n_slabs: int
    full: int
    tail: int
    splits: int
    units: int
    grid: int


def _slab_clocks(bn: int) -> float:
    return max(_TENSOR_CLK_PER_N * bn,
               (2 * CONV_PATCH_ROWS * CONV_SLAB * 2 + bn * CONV_SLAB * 2)
               / _L2_BYTES_PER_CLK)


def conv_patch(h: int, w: int):
    """(bh, bw): the patch with bh * bw <= 64, bh <= h, bw <= w, that
    needs the fewest patches per image; on a tie the one whose 3x3 halo
    (bh + 2)(bw + 2) is smallest, then the wider."""
    best = None
    for bw in range(1, min(w, CONV_PATCH_ROWS) + 1):
        bh = min(h, CONV_PATCH_ROWS // bw)
        key = (-(-h // bh) * -(-w // bw), (bh + 2) * (bw + 2), -bw)
        if best is None or key < best[0]:
            best = (key, bh, bw)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def conv_config(b: int, h: int, w: int, c: int, cout: int,
                n_sm: int = 132) -> ConvConfig:
    """The kernel's launch configuration for x (b, h, w, c) and Cout
    ``cout`` on ``n_sm`` SMs: pure, by wave arithmetic.

    The patch is :func:`conv_patch`'s.  The whole waves of tiles run
    whole; the tiles left over, which would leave SMs idle, may be split.
    Of the tile widths :data:`CONV_BLOCK_N` and 1 to 16 splits of the
    tail, the pair with the least modelled time wins: whole waves of
    n_slabs slabs, plus ceil(tail * splits / n_sm) waves of
    ceil(n_slabs / splits) slabs, at the module's cost model's slab time,
    plus the partials' traffic and the reduction's launch where
    splits > 1.  On a tie the wider tile and the fewer splits.  The grid
    is one block per SM, or one per unit where there are fewer."""
    if min(b, h, w) < 1 or c < 8 or cout < 8 or c % 8 or cout % 8:
        raise ValueError(f"conv3x3 kernel needs B, H, W >= 1 and C, Cout "
                         f"multiples of 8, got {(b, h, w, c, cout)}")
    bh, bw = conv_patch(h, w)
    py, px = -(-h // bh), -(-w // bw)
    patches = b * py * px
    m_tiles = -(-patches // 2)
    n_slabs = 9 * -(-c // CONV_SLAB)
    best = None
    for bn in CONV_BLOCK_N:
        n_tiles = -(-cout // bn)
        tiles = m_tiles * n_tiles
        tail = tiles % n_sm
        for splits in range(1, min(n_slabs, CONV_MAX_SPLITS) + 1):
            if splits > 1 and not tail:
                break
            slab = _slab_clocks(bn)
            clk = tiles // n_sm * n_slabs * slab
            clk += -(-tail * splits // n_sm) * -(-n_slabs // splits) * slab
            if splits > 1:
                clk += ((8 * splits + 2) * tail * 128 * bn
                        / _HBM_BYTES_PER_CLK + _REDUCE_LAUNCH_CLK)
            key = (clk, -bn, splits)
            if best is None or key < best[0]:
                best = (key, bn, n_tiles, tiles, splits)
    _, bn, n_tiles, tiles, splits = best
    full = tiles if splits == 1 else tiles - tiles % n_sm
    units = full + (tiles - full) * splits
    return ConvConfig(bh, bw, py, px, patches, m_tiles, bn, n_tiles, n_slabs,
                      full, tiles - full, splits, units, min(units, n_sm))


def split_range(n_slabs: int, splits: int, s: int):
    """[lo, hi): the K slabs of split ``s``, as the kernel cuts them."""
    return s * n_slabs // splits, (s + 1) * n_slabs // splits


def unit_work(cfg: ConvConfig, u: int):
    """(M tile, N tile, split, first slab, end slab) of unit ``u``, as the
    kernel's walk decodes it (``csrc/conv3x3.cu`` unit_of): the whole
    tiles first, then each split of the tail tiles, tile fastest."""
    tile, split, k0, k1 = u, 0, 0, cfg.n_slabs
    if u >= cfg.full:
        split, slot = divmod(u - cfg.full, cfg.tail)
        tile = cfg.full + slot
        k0, k1 = split_range(cfg.n_slabs, cfg.splits, split)
    return tile % cfg.m_tiles, tile // cfg.m_tiles, split, k0, k1


def patch_origin(cfg: ConvConfig, p: int):
    """(image, first row, first column) of patch ``p``."""
    b, r = divmod(p, cfg.patches_y * cfg.patches_x)
    return b, (r // cfg.patches_x) * cfg.bh, (r % cfg.patches_x) * cfg.bw


def conv3x3_nhwc_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, Cout) -> (B, H, W, Cout) in x's dtype:
    nine shifted (B*H*W, C) @ (C, Cout) products of the zero-padded input,
    summed in fp32."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b * h * wd, cout), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c)
            acc += tap.float() @ w[dy, dx].float()
    return acc.reshape(b, h, wd, cout).to(x.dtype)


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """See :func:`conv3x3_nhwc_plain`.  The kernel takes contiguous bf16
    tensors on one card with C and Cout multiples of 8, aligned to 16
    bytes.  Where :func:`conv_config` splits tiles, the wrapper allocates
    their fp32 partial tiles (splits, tail, 128, bn) and the launch reduces
    them in split order: two calls on the same inputs give the same
    bits."""
    if not use_kernel(x, w):
        return conv3x3_nhwc_plain(x, w)
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 kernel takes x (B, H, W, C) and w "
                         f"(3, 3, C, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel takes bf16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3 kernel: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 kernel takes contiguous tensors")
    b, h, wd, c = x.shape
    cout = w.shape[3]
    if c % 8 or cout % 8:
        raise ValueError(f"conv3x3 kernel takes C and Cout multiples of 8, "
                         f"got {c} and {cout}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 kernel takes x and w aligned to 16 bytes")
    if b * h * wd * max(c, cout) >= 2 ** 31:
        raise ValueError(f"conv3x3 kernel: {tuple(x.shape)} is too large")
    dev = x.get_device()
    cfg = conv_config(b, h, wd, c, cout, _kernels.sm_count(dev))
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    partial = None
    if cfg.tail:
        partial = torch.empty((cfg.splits, cfg.tail, 128, cfg.bn),
                              dtype=torch.float32, device=x.device)
    status = _kernels.lib().ik_conv3x3(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        0 if partial is None else partial.data_ptr(), b, h, wd, c, cout,
        cfg.bh, cfg.bw, cfg.bn, cfg.splits, cfg.full, cfg.grid,
        _kernels.stream(dev))
    _kernels.check(status, "conv3x3")
    _kernels.count_launch("conv3x3")
    return out
