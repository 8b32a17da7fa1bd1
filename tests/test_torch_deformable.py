"""Port parity: multi-scale deformable attention
(inklayer_tpu_torch.ops.deformable) against the JAX package: the fp64
numpy oracle ms_deform_attn_ref, the fp32 gather formulation, and the
Pallas kernels in interpret mode: fused v3 and tiled (the production
paths), and the per-level (v1, v2) and all-heads fused v4 kernels, which
no caller reaches but which compute the same function.

Tolerances: fp32 atol = rtol = 1e-5 against the fp64 oracle and the gather
path; the Pallas kernels sample bf16 values with bf16 weights, so against
them atol = rtol = 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.ops.deformable import (_ms_deform_attn_gather,
                                         _ms_deform_attn_pallas,
                                         _ms_deform_attn_pallas_fused,
                                         _ms_deform_attn_pallas_tiled,
                                         _tiled_plan, ms_deform_attn_ref)
from inklayer_tpu_torch.ops.deformable import ms_deform_attn

BF16 = dict(atol=2e-2, rtol=2e-2)


def _case(rng, b, heads, d, shapes, lq, n_points, lo=-0.2, hi=1.2):
    n_tokens = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, n_tokens, heads, d)).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, lq, heads, len(shapes), n_points, 2)
                       ).astype(np.float32)
    wts = rng.random((b, lq, heads, len(shapes), n_points)).astype(np.float32)
    wts /= wts.sum(axis=(-1, -2), keepdims=True)
    return value, locs, wts


def _port(value, shapes, locs, wts):
    return ms_deform_attn(torch.from_numpy(value), shapes,
                          torch.from_numpy(locs), torch.from_numpy(wts)).numpy()


def test_plain_matches_fp64_oracle_and_gather(rng):
    shapes = ((6, 8), (3, 4), (2, 2))
    value, locs, wts = _case(rng, 2, 2, 4, shapes, 7, 3)
    got = _port(value, shapes, locs, wts)
    np.testing.assert_allclose(got, ms_deform_attn_ref(value, shapes, locs,
                                                       wts),
                               atol=1e-5, rtol=1e-5)
    gather = _ms_deform_attn_gather(jnp.asarray(value), shapes,
                                    jnp.asarray(locs), jnp.asarray(wts))
    np.testing.assert_allclose(got, np.asarray(gather), atol=1e-5, rtol=1e-5)


def test_plain_exact_pixel_centre(rng):
    shapes = ((4, 4),)
    value = rng.standard_normal((1, 16, 1, 2)).astype(np.float32)
    locs = np.array([[[[[(2.5 / 4, 1.5 / 4)]]]]], np.float32)
    got = _port(value, shapes, locs, np.ones((1, 1, 1, 1, 1), np.float32))
    np.testing.assert_allclose(got[0, 0], value[0, 6, 0], atol=1e-6)


def test_plain_matches_pallas_fused_v3_interpret(rng):
    shapes = ((10, 12), (5, 6))
    value, locs, wts = _case(rng, 1, 2, 8, shapes, 9, 4)
    want = _ms_deform_attn_pallas_fused(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(wts),
        block_q=8, interpret=True, kernel_version=3)
    np.testing.assert_allclose(_port(value, shapes, locs, wts),
                               np.asarray(want), **BF16)


def test_plain_matches_pallas_fused_v4_interpret(rng):
    """kernel_version=4: all heads per program (_pallas_fused_allheads_kernel,
    the transpose-free host layouts)."""
    shapes = ((10, 12), (5, 6))
    value, locs, wts = _case(rng, 1, 2, 8, shapes, 9, 4)
    want = _ms_deform_attn_pallas_fused(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(wts),
        block_q=8, interpret=True, kernel_version=4)
    np.testing.assert_allclose(_port(value, shapes, locs, wts),
                               np.asarray(want), **BF16)


@pytest.mark.parametrize("kernel_version", [1, 2])
def test_plain_matches_pallas_per_level_interpret(rng, kernel_version):
    """impl="pallas_per_level": one pallas_call per level
    (_pallas_level_kernel, _pallas_level_kernel_v2), summed outside."""
    shapes = ((10, 12), (5, 6), (3, 4))
    value, locs, wts = _case(rng, 1, 2, 8, shapes, 9, 2)
    want = _ms_deform_attn_pallas(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(wts),
        block_q=8, interpret=True, kernel_version=kernel_version)
    np.testing.assert_allclose(_port(value, shapes, locs, wts),
                               np.asarray(want), **BF16)


def test_plain_matches_pallas_tiled_interpret(rng):
    """Encoder layout: raster queries of every level with small offsets
    around their centres.  Level 0 is x-windowed (width > 48) and tiled
    (50-row tiles); the other levels go through the fused tail."""
    shapes = ((50, 56), (25, 28), (13, 14))
    assert _tiled_plan(shapes, 16) is not None
    refs = []
    for hh, ww in shapes:
        yy, xx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
        refs.append(np.stack([(xx.ravel() + 0.5) / ww,
                              (yy.ravel() + 0.5) / hh], -1))
    ref = np.concatenate(refs, 0)
    lq = len(ref)
    value, _, wts = _case(rng, 1, 1, 16, shapes, lq, 1)
    offs = rng.uniform(-0.03, 0.03, (1, lq, 1, len(shapes), 1, 2))
    locs = (ref[None, :, None, None, None, :] + offs).astype(np.float32)
    want = _ms_deform_attn_pallas_tiled(
        jnp.asarray(value, jnp.bfloat16), shapes, jnp.asarray(locs),
        jnp.asarray(wts), interpret=True)
    np.testing.assert_allclose(_port(value, shapes, locs, wts),
                               np.asarray(want, np.float32), **BF16)


def test_bf16_values_accumulate_in_fp32(rng):
    """bf16 values give a bf16 result equal to the fp32 computation on the
    same (bf16-representable) values, up to the final rounding."""
    shapes = ((6, 8), (3, 4))
    value, locs, wts = _case(rng, 1, 2, 32, shapes, 5, 4)
    vb = torch.from_numpy(value).to(torch.bfloat16)
    got = ms_deform_attn(vb, shapes, torch.from_numpy(locs),
                         torch.from_numpy(wts))
    assert got.dtype == torch.bfloat16
    want = ms_deform_attn_ref(vb.float().numpy(), shapes, locs, wts)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_kernel_level_table():
    """The level table the kernel takes by value: S, then heights, widths
    and token offsets padded to 8 levels; built once per shape set; more
    than 8 levels refused."""
    from inklayer_tpu_torch.ops.deformable import level_table

    shapes = ((100, 100), (50, 50), (25, 25), (13, 13))
    table = level_table(shapes)
    assert table == (13294, 100, 50, 25, 13, 0, 0, 0, 0,
                     100, 50, 25, 13, 0, 0, 0, 0,
                     0, 10000, 12500, 13125, 0, 0, 0, 0)
    assert level_table(tuple(shapes)) is table
    assert level_table(((3, 5),)) == (15, 3, *[0] * 7, 5, *[0] * 7,
                                      *[0] * 8)
    with pytest.raises(ValueError):
        level_table(((1, 1),) * 9)
    with pytest.raises(ValueError):
        level_table(())
