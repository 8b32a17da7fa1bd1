"""Port parity: the 3x3 same-pad NHWC convolution (``ops/conv.py``).

The reference is the prototype's own check, ``xla_conv`` in
``scripts/ablate_pallas_conv.py`` ``main()``:
``jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
dimension_numbers=("NHWC", "HWIO", "NHWC"))``.  The Pallas prototype
itself cannot run on the CPU: it sets TPU compiler parameters
(``pltpu.CompilerParams``, VMEM scratch) and has no interpret switch.  So
the port's plain version (the shift-9 sum the prototype's
``make_pallas_conv`` computes) is held to ``xla_conv`` in fp32 at
atol = rtol = 1e-4; the CUDA kernel is held to the plain version on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu_torch.ops import conv


def _xla_conv(x, w):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))


@pytest.mark.parametrize("shape,cout", [((2, 12, 12, 32), 32),
                                        ((1, 10, 14, 48), 64),
                                        ((1, 1, 5, 8), 16)])
def test_plain_matches_xla_conv(shape, cout):
    rng = np.random.default_rng(sum(shape) + cout)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.1).astype(
        np.float32)
    got = conv.conv3x3_nhwc_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == shape[:3] + (cout,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _xla_conv(x, w), atol=1e-4,
                               rtol=1e-4)


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 16)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 16, 8)).astype(
        np.float32))
    torch.testing.assert_close(conv.conv3x3_nhwc(x, w),
                               conv.conv3x3_nhwc_plain(x, w), atol=0, rtol=0)


def test_halo_is_zero_padding():
    """A one-hot weight at each tap shifts the image by that tap's offset,
    with zeros entering at the border."""
    x = torch.arange(1, 1 + 4 * 5, dtype=torch.float32).reshape(1, 4, 5, 1)
    for dy in range(3):
        for dx in range(3):
            w = torch.zeros(3, 3, 1, 1)
            w[dy, dx] = 1.0
            got = conv.conv3x3_nhwc_plain(x, w)[0, :, :, 0]
            want = torch.nn.functional.pad(x[0, :, :, 0], (1, 1, 1, 1))[
                dy:dy + 4, dx:dx + 5]
            torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# conv_config: the launch configuration of csrc/conv3x3.cu (pure; the card
# tests run the kernel it configures)
# ---------------------------------------------------------------------------

LEVELS = [(2, 96, 96, 320, 320), (2, 48, 48, 640, 640),
          (2, 24, 24, 1280, 1280), (2, 12, 12, 1280, 1280)]
# (bh, bw, bn, full, tail, splits, grid) per level on 132 SMs, as the head
# of csrc/conv3x3.cu states them
LEVEL_CONFIGS = [(8, 8, 192, 264, 24, 5, 132), (8, 8, 256, 108, 0, 1, 108),
                 (8, 8, 192, 0, 63, 2, 126), (12, 4, 192, 0, 21, 6, 126)]
RAGGED = [(3, 7, 5, 8, 136), (2, 33, 17, 72, 200), (1, 1, 1, 16, 8),
          (1, 1, 9, 24, 40), (3, 23, 22, 64, 96), (1, 9, 9, 136, 72),
          (2, 20, 18, 200, 136), (1, 300, 2, 8, 8)]


@pytest.mark.parametrize("level", range(4))
def test_conv_config_at_the_levels(level):
    cfg = conv.conv_config(*LEVELS[level])
    assert (cfg.bh, cfg.bw, cfg.bn, cfg.full, cfg.tail, cfg.splits,
            cfg.grid) == LEVEL_CONFIGS[level]


@pytest.mark.parametrize("shape,n_sm", [(s, 132) for s in LEVELS + RAGGED]
                         + [(s, n) for s in RAGGED[:5] for n in (3, 16)])
def test_conv_config_covers_the_work_once(shape, n_sm):
    """Every output pixel lies in exactly one patch; every (tile, slab)
    is computed by exactly one unit (the splits partition the 9 *
    ceil(C / 64) slabs of each split tile); the grid is at most one block
    per SM."""
    b, h, w, c, cout = shape
    cfg = conv.conv_config(b, h, w, c, cout, n_sm)
    assert 1 <= cfg.bh <= h and 1 <= cfg.bw <= w
    assert cfg.bh * cfg.bw <= conv.CONV_PATCH_ROWS
    assert cfg.bn in conv.CONV_BLOCK_N and cfg.n_slabs == 9 * -(-c // 64)
    seen = np.zeros((b, h, w), np.int64)
    for p in range(cfg.patches):
        bi, y0, x0 = conv.patch_origin(cfg, p)
        seen[bi, y0:y0 + cfg.bh, x0:x0 + cfg.bw] += 1
    assert (seen == 1).all()
    assert cfg.m_tiles == -(-cfg.patches // 2)
    tiles = cfg.m_tiles * cfg.n_tiles
    assert cfg.n_tiles * cfg.bn >= cout > (cfg.n_tiles - 1) * cfg.bn
    assert cfg.full + cfg.tail == tiles
    assert (cfg.splits == 1) == (cfg.tail == 0)
    assert cfg.units == cfg.full + cfg.tail * cfg.splits
    assert 1 <= cfg.grid <= min(n_sm, cfg.units)
    done = np.zeros((cfg.m_tiles, cfg.n_tiles, cfg.n_slabs), np.int64)
    for u in range(cfg.units):
        mt, nt, split, k0, k1 = conv.unit_work(cfg, u)
        assert k0 < k1 and (split == 0 or u >= cfg.full)
        done[mt, nt, k0:k1] += 1
    assert (done == 1).all()


def test_conv_config_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiples of 8"):
        conv.conv_config(1, 8, 8, 12, 16)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv.conv_config(0, 8, 8, 16, 16)


def _kernel_model(x, w, cfg):
    """numpy model of csrc/conv3x3.cu's decomposition: per unit, the two
    patches' 4-D boxes (zeros outside the image and past C), the weight
    boxes at rows tap * C + c0 (past C the next tap's rows, met by zero
    channels; zeros past 9C and Cout), whole tiles stored masked, split
    tiles' partials added in split order, then stored masked."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    n_cc = -(-c // 64)
    wk = np.zeros((9 * c + 64, cfg.n_tiles * cfg.bn), np.float64)
    wk[:9 * c, :cout] = w.reshape(9 * c, cout)
    xp = np.zeros((b + 1, h + 2 + cfg.bh, wd + 2 + cfg.bw, n_cc * 64))
    xp[:b, 1:h + 1, 1:wd + 1, :c] = x
    out = np.full((b, h, wd, cout), np.nan)
    writes = np.zeros((b, h, wd, cout), np.int64)
    partial = np.zeros((cfg.splits, cfg.tail, 128, cfg.bn))
    rows = np.arange(conv.CONV_PATCH_ROWS)
    ry, rx = rows // cfg.bw, rows % cfg.bw
    live = rows < cfg.bh * cfg.bw

    def store(acc, mt, nt):
        for i in range(2):
            p = 2 * mt + i
            if p >= cfg.patches:
                continue
            bi, y0, x0 = conv.patch_origin(cfg, p)
            y, xx = y0 + ry, x0 + rx
            ok = live & (y < h) & (xx < wd)
            n0 = nt * cfg.bn
            n1 = min(n0 + cfg.bn, cout)
            out[bi, y[ok], xx[ok], n0:n1] = acc[64 * i:64 * i + 64][ok,
                                                                   :n1 - n0]
            writes[bi, y[ok], xx[ok], n0:n1] += 1

    for u in range(cfg.units):
        mt, nt, split, k0, k1 = conv.unit_work(cfg, u)
        origins = [conv.patch_origin(cfg, p if p < cfg.patches else 2 * mt)
                   for p in (2 * mt, 2 * mt + 1)]
        acc = np.zeros((128, cfg.bn))
        for k in range(k0, k1):
            tap, cc = divmod(k, n_cc)
            dy, dx = divmod(tap, 3)
            a = np.zeros((128, 64))
            for i, (bi, y0, x0) in enumerate(origins):
                # xp is padded by one: box row (y0 + dy - 1) is xp row y0 + dy
                a[64 * i:64 * i + 64][live] = xp[
                    bi, y0 + dy + ry[live], x0 + dx + rx[live],
                    64 * cc:64 * cc + 64]
            r0 = tap * c + 64 * cc
            acc += a @ wk[r0:r0 + 64, nt * cfg.bn:(nt + 1) * cfg.bn]
        if u < cfg.full:
            store(acc, mt, nt)
        else:
            partial[split, u - cfg.full - split * cfg.tail] = acc
    for slot in range(cfg.tail):
        tile = cfg.full + slot
        total = partial[0, slot].copy()
        for s in range(1, cfg.splits):
            total += partial[s, slot]
        store(total, tile % cfg.m_tiles, tile // cfg.m_tiles)
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("shape,n_sm", [
    ((3, 7, 5, 8, 136), 132), ((1, 10, 14, 48, 64), 132),
    ((3, 23, 22, 64, 96), 132), ((2, 9, 7, 72, 40), 132),
    ((1, 9, 9, 136, 72), 132), ((2, 33, 17, 72, 200), 7),
    ((3, 23, 22, 64, 96), 5), ((1, 1, 9, 24, 40), 132)])
def test_kernel_decomposition_matches_the_plain_version(shape, n_sm):
    """The kernel's tiling, halo, channel and split arithmetic (numpy
    model) computes the plain version's convolution; a few SMs force whole
    waves and a split tail at small shapes."""
    b, h, w, c, cout = shape
    cfg = conv.conv_config(b, h, w, c, cout, n_sm)
    rng = np.random.default_rng(sum(shape) + n_sm)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32)
    want = conv.conv3x3_nhwc_plain(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(_kernel_model(x, wt, cfg), want.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_card_cases_reach_the_edges():
    """The card tests' edge cases (tests/test_torch_kernels_gpu.py) reach
    what they are there for, on an H100's 132 SMs."""
    cfg = conv.conv_config(3, 23, 22, 64, 96)  # B = 3, the last patch
    b, y0, x0 = conv.patch_origin(cfg, cfg.patches - 1)
    assert (b, y0 + cfg.bh > 23, x0 + cfg.bw > 22) == (2, True, True)
    assert cfg.patches % 2 == 1  # the last tile has one patch
    cfg = conv.conv_config(2, 20, 18, 200, 136)
    assert 200 % 64 and 136 % 64 and cfg.splits > 1 and cfg.tail
