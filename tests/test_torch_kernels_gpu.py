"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``gpu``: without a CUDA device every test
skips (the CPU tests cover the plain versions' parity with the JAX
package).  Run on a card with

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Inputs are seeded bf16; the plain version runs in fp32 on the same card
with TF32 off.  Tolerance atol = rtol = 2e-2 (bf16 outputs; the attention
rounds its probabilities and the MLP its hidden activation to bf16), and
for the attention and GEMM kernels a relative L2 error <= 5e-3.  The
connected-components kernels are exact: labels and cleaned masks equal
their plain versions bit for bit.  The 3x3 convolution sums up to
9 * 1280 products in fp32 before one bf16 rounding, so it is held to a
relative L2 error <= 5e-3 and element-wise to 1e-2 / 1e-2.
"""

import pytest
import torch

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.ops import (attention, components, conv, deformable,
                                    mlp, norm)
from torch_masks import MASK_KINDS, adversarial_mask, straddle_stack

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(
        torch.bfloat16)


def _f32(ts):
    return [t.float() for t in ts]


def _rel_l2(got, want):
    return float((got.float() - want).norm() / want.norm())


# N = kh * kw: one key (1), partial query and key tiles (70, 100, 196,
# 1369), kh != kw (8 x 12, 7 x 10), odd BH, SAM's windows (14 x 14) and
# global grids (64 x 64 at 1024^2, 48 x 48 at 768^2)
@pytest.mark.parametrize("bh,kh,kw,d", [
    (8, 14, 14, 80), (4, 64, 64, 80), (6, 8, 8, 64), (2, 48, 48, 80),
    (3, 8, 12, 64), (1, 1, 1, 80), (3, 7, 10, 64), (5, 10, 10, 80),
    (3, 14, 14, 64), (3, 37, 37, 80)])
def test_relpos_attention_kernel(gen, bh, kh, kw, d):
    """Also to a relative L2 error <= 5e-3: a kernel that left the tail
    keys unmasked scales whole rows, which hides inside the rtol."""
    n = kh * kw
    args = [_randn(gen, bh, n, d) for _ in range(3)] + \
        [_randn(gen, bh, n, kh), _randn(gen, bh, n, kw)]
    before = _kernels.LAUNCHES["relpos_attention"]
    got = attention.relpos_attention(*args, d ** -0.5)
    assert _kernels.LAUNCHES["relpos_attention"] == before + 1
    want = attention.relpos_attention_plain(*_f32(args), d ** -0.5)
    torch.testing.assert_close(got.float(), want, **TOL)
    assert _rel_l2(got, want) <= 5e-3


# fc1 at K 128 (fewer K slabs than ring stages), 1024 and 4096 tokens of
# SAM ViT-H (fc1 128 x 256 tiles, fc2 128 x 160)
@pytest.mark.parametrize("t,c,h", [(512, 128, 512), (1024, 1280, 5120),
                                   (4096, 1280, 5120)])
def test_mlp_gelu_kernel(gen, t, c, h):
    args = [_randn(gen, t, c), _randn(gen, h, c, std=c ** -0.5),
            _randn(gen, h, std=0.1), _randn(gen, c, h, std=h ** -0.5),
            _randn(gen, c, std=0.1)]
    before = _kernels.LAUNCHES["mlp_gelu"]
    got = mlp.mlp_gelu(*args)
    assert _kernels.LAUNCHES["mlp_gelu"] == before + 1
    want = mlp.mlp_gelu_plain(*_f32(args))
    torch.testing.assert_close(got.float(), want, **TOL)
    assert _rel_l2(got, want) <= 5e-3


# every tile width at every epilogue, a grid smaller than the tile count
# (several tiles per block), and K % 64 == 32 (TMA zero-fills the last slab)
@pytest.mark.parametrize("m,n,k,bn,grid", [
    (128, 128, 64, 128, 1), (256, 256, 160, 128, 3), (256, 512, 96, 256, 1),
    (512, 640, 256, 160, 5), (384, 1280, 5120, 160, 7),
    (4096, 1280, 5120, 256, 132)])
@pytest.mark.parametrize("gelu", [True, False])
def test_gemm_kernel_tile_widths(gen, m, n, k, bn, grid, gelu):
    a = _randn(gen, m, k)
    w = _randn(gen, n, k, std=k ** -0.5)
    b = _randn(gen, n, std=0.1)
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    status = _kernels.lib().ik_linear_bias_act(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        int(gelu), bn, grid, _kernels.stream(0))
    _kernels.check(status, "mlp_gelu")
    want = torch.nn.functional.linear(*_f32([a, w, b]))
    if gelu:
        want = torch.nn.functional.gelu(want)
    torch.testing.assert_close(out.float(), want, **TOL)
    assert _rel_l2(out, want) <= 5e-3


# chip_smoke's phase-2 shapes, a last row group left partly empty (513 rows
# of 4 lanes at C 96: 8 rows per warp), C 4096, and C 272 (no even split:
# the whole warp with guarded vectors)
@pytest.mark.parametrize("rows,c", [
    (4096, 1280), (40000, 96), (1370, 768), (18432, 320), (4608, 640),
    (1152, 1280), (513, 96), (512, 96), (777, 1280), (1000, 256),
    (600, 4096), (512, 272)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_kernel(gen, rows, c, dtype):
    x, y = (_randn(gen, rows, c).to(dtype) for _ in range(2))
    sc = (1 + _randn(gen, c, std=0.1)).to(dtype)
    bi = _randn(gen, c, std=0.1).to(dtype)
    if dtype == torch.float32 and c > 2048:  # 16 vectors of 4 on 32 lanes
        with pytest.raises(ValueError):
            norm.layernorm_2d(x, sc, bi)
        return
    before = _kernels.LAUNCHES["layernorm"]
    torch.testing.assert_close(norm.layernorm_2d(x, sc, bi).float(),
                               norm.layernorm_2d_plain(*_f32([x, sc, bi])),
                               **TOL)
    s, o = norm.layernorm_residual_2d(x, y, sc, bi)
    assert _kernels.LAUNCHES["layernorm"] == before + 2
    s_w, o_w = norm.layernorm_residual_2d_plain(*_f32([x, y, sc, bi]))
    torch.testing.assert_close(s.float(), s_w, **TOL)
    torch.testing.assert_close(o.float(), o_w, **TOL)


@pytest.mark.parametrize("lq", [37, 900])
def test_ms_deform_attn_kernel(gen, lq):
    shapes = ((20, 24), (10, 12), (5, 6), (3, 3))
    s = sum(h * w for h, w in shapes)
    value = _randn(gen, 2, s, 8, 32)
    loc = torch.rand(2, lq, 8, 4, 4, 2, generator=gen, device="cuda") * 1.4 - 0.2
    att = torch.softmax(torch.randn(2, lq, 8, 16, generator=gen,
                                    device="cuda"), -1).reshape(2, lq, 8, 4, 4)
    got = deformable.ms_deform_attn(value, shapes, loc, att)
    want = deformable.ms_deform_attn_plain(value.float(), shapes, loc, att)
    torch.testing.assert_close(got.float(), want, **TOL)


# N below one 128-key tile (1, 64, 70, 100), exactly one (128), with
# partial query and key tiles (196, 1370) and the production shapes; odd BH
@pytest.mark.parametrize("bh,n,d", [(12, 1370, 64), (3, 64, 64),
                                    (2, 100, 64), (1, 1, 64),
                                    (4, 2304, 40), (2, 70, 40), (1, 1, 40),
                                    (4, 2304, 80), (2, 100, 80),
                                    (3, 100, 40), (3, 196, 40),
                                    (3, 1370, 40), (3, 70, 64), (5, 196, 64),
                                    (1, 1, 80), (3, 70, 80), (3, 196, 80),
                                    (3, 1370, 80), (1, 128, 40)])
def test_flash_attention_kernel(gen, bh, n, d):
    """head_dim 40 runs on boxes padded to 48 columns by TMA's zero fill: a
    kernel that scaled by 48 ** -0.5 or read the pad columns from the next
    row fails the L2 limit."""
    q, k, v = (_randn(gen, bh, n, d) for _ in range(3))
    before = _kernels.launch_counts()
    got = attention.flash_attention(q, k, v)
    after = _kernels.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    key = f"flash_attention/d{d}"
    assert after[key] == before.get(key, 0) + 1
    want = attention.flash_attention_plain(*_f32([q, k, v]), d ** -0.5)
    torch.testing.assert_close(got.float(), want, **TOL)
    # a uniform scaling (unmasked padded keys) hides inside the rtol above
    assert _rel_l2(got, want) <= 5e-3


def _blob_stack(gen, n, h, w):
    """Blobs (thresholded smoothed noise), thin strokes and speckle."""
    noise = torch.rand(n, 1, h // 8, w // 8, generator=gen, device="cuda")
    blobs = torch.nn.functional.interpolate(noise, size=(h, w),
                                            mode="bilinear")[:, 0] > 0.6
    speckle = torch.rand(n, h, w, generator=gen, device="cuda") > 0.995
    masks = blobs | speckle
    masks[:, h // 3, 5:w - 5] = True
    masks[:, 5:h - 5, w // 2] = True
    return masks


@pytest.mark.parametrize("n,h,w", [(4, 64, 80), (8, 300, 257), (2, 750, 750)])
def test_connected_components_kernel(gen, n, h, w):
    masks = _blob_stack(gen, n, h, w)
    before = _kernels.LAUNCHES["connected_components"]
    got = components.connected_components(masks)
    assert _kernels.LAUNCHES["connected_components"] == before + 1
    assert torch.equal(got, components.connected_components_plain(masks))


@pytest.mark.parametrize("n,h,w", [(4, 64, 80), (8, 300, 257), (2, 750, 750)])
def test_clean_components_kernel(gen, n, h, w):
    masks = _blob_stack(gen, n, h, w)
    before = _kernels.LAUNCHES["clean_components"]
    got, capped = components.clean_components(masks, 50, 1.1)
    assert _kernels.LAUNCHES["clean_components"] == before + 1
    want, _ = components.clean_components_plain(masks, 50, 1.1)
    assert torch.equal(got, want) and not capped.any()
    assert 0 < int(got.sum()) < int(masks.sum())  # some kept, some dropped


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 36, 32)  # head_dim 32: no kernel instance
    r = _randn(gen, 2, 36, 6)
    with pytest.raises(ValueError):
        attention.relpos_attention(q, q, q, r, r, 0.2)
    x = _randn(gen, 100, 128)  # rows % 128 != 0
    w = _randn(gen, 512, 128)
    with pytest.raises(ValueError):
        mlp.mlp_gelu(x, w, _randn(gen, 512), _randn(gen, 128, 512),
                     _randn(gen, 128))
    for d in (32, 48, 128):  # no flash instance
        q = _randn(gen, 2, 300, d)
        with pytest.raises(ValueError):
            attention.flash_attention(q, q, q)
    with pytest.raises(ValueError):  # components take bool masks
        components.connected_components(_randn(gen, 2, 8, 8))
    a, w, b = _randn(gen, 512, 48), _randn(gen, 512, 48), _randn(gen, 512)
    with pytest.raises(ValueError):  # K % 32 != 0
        mlp.mlp_gelu(a, w, b, _randn(gen, 128, 512), _randn(gen, 128))
    a, w = _randn(gen, 512, 128), _randn(gen, 512, 128)
    with pytest.raises(ValueError):  # bias is not (H,)
        mlp.mlp_gelu(a, w, _randn(gen, 256), _randn(gen, 128, 512),
                     _randn(gen, 128))
    with pytest.raises(ValueError):  # fp32
        mlp.mlp_gelu(a.float(), w.float(), _randn(gen, 512).float(),
                     _randn(gen, 128, 512).float(), _randn(gen, 128).float())
    with pytest.raises(ValueError):  # not contiguous
        mlp.mlp_gelu(_randn(gen, 128, 512).t(), w, _randn(gen, 512),
                     _randn(gen, 128, 512), _randn(gen, 128))
    x, sc = _randn(gen, 512, 100), _randn(gen, 100)
    with pytest.raises(ValueError):  # C % 8 != 0 (bf16)
        norm.layernorm_2d(x, sc, sc)
    x, sc = _randn(gen, 512, 128), _randn(gen, 128)
    with pytest.raises(TypeError):  # scale in another dtype
        norm.layernorm_2d(x, sc.float(), sc)
    with pytest.raises(TypeError):  # float16
        norm.layernorm_2d(x.half(), sc.half(), sc.half())
    with pytest.raises(ValueError):  # not contiguous
        norm.layernorm_2d(_randn(gen, 512, 256)[:, :128], sc, sc)
    with pytest.raises(ValueError):  # residual of another shape
        norm.layernorm_residual_2d(x, _randn(gen, 256, 128), sc, sc)
    with pytest.raises(ValueError):  # scale not (C,)
        norm.layernorm_2d(x, _randn(gen, 64), sc)
    shapes, value, loc, att = _msda_inputs(gen, 1, 16, 2, 4, torch.bfloat16,
                                           "uniform")
    buf = torch.empty(value.numel() + 1, dtype=value.dtype, device="cuda")
    with pytest.raises(ValueError):  # contiguous, value not on 16 bytes
        deformable.ms_deform_attn(buf[1:].view(value.shape), shapes, loc, att)
    buf = torch.empty(loc.numel() + 1, device="cuda")
    with pytest.raises(ValueError):  # contiguous, locations not on 8 bytes
        deformable.ms_deform_attn(value, shapes, buf[1:].view(loc.shape), att)


# ---------------------------------------------------------------------------
# connected components: masks aimed at the tile decomposition (tiles of
# 32 x 32 pixels; corners of every 16-pixel grid cover 16 x 64 tiles too)
# ---------------------------------------------------------------------------

# H and W that are and are not multiples of the tile, one row, one column,
# one pixel
SHAPES = ((1, 750, 750), (2, 33, 33), (1, 1, 750), (1, 750, 1), (1, 1, 1),
          (3, 100, 96), (2, 64, 64))


def _stack(kind, n, h, w):
    m = adversarial_mask(kind, h, w)
    # mask i: the pattern shifted by i pixels, so each meets the tile
    # borders at another phase
    return torch.stack([torch.roll(m, (i, 2 * i), (0, 1))
                        for i in range(n)]).cuda()


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("n,h,w", SHAPES)
def test_connected_components_adversarial(gen, kind, n, h, w):
    masks = _stack(kind, n, h, w)
    got = components.connected_components(masks)
    assert torch.equal(got, components.connected_components_plain(masks))


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("n,h,w", SHAPES)
def test_clean_components_adversarial(gen, kind, n, h, w):
    masks = _stack(kind, n, h, w)
    got, capped = components.clean_components(masks, 50, 1.1)
    want, _ = components.clean_components_plain(masks, 50, 1.1)
    assert torch.equal(got, want) and not capped.any()


@pytest.mark.parametrize("n,h,w", [(2, 1, 3), (4, 3, 3), (4, 1, 6),
                                   (4, 7, 11), (3, 27, 37), (4, 33, 33),
                                   (2, 750, 751)])
def test_clean_components_groups_straddle_masks(gen, n, h, w):
    """The keep pass takes four pixels of the stack at a time; where H * W
    % 4 != 0 they straddle two masks, whose roots 0 are two components: a
    full mask (kept) and a lone pixel at (0, 0) (dropped)."""
    masks = straddle_stack(n, h, w).cuda()
    got, capped = components.clean_components(masks, 2, 2.0)
    want, _ = components.clean_components_plain(masks, 2, 2.0)
    assert torch.equal(got, want) and not capped.any()
    assert got[0::2].all() and not got[1::2].any()


def test_components_take_masks_at_an_odd_byte_offset(gen):
    """A contiguous view that starts at an odd address: the kernels load a
    row's two bytes at once only where the pair is aligned."""
    masks = _blob_stack(gen, 3, 64, 80)
    flat = torch.zeros(masks.numel() + 1, dtype=torch.bool, device="cuda")
    flat[1:] = masks.reshape(-1)
    odd = flat[1:].view(masks.shape)
    assert odd.is_contiguous() and odd.data_ptr() % 2 == 1
    assert torch.equal(components.connected_components(odd),
                       components.connected_components_plain(masks))
    got, _ = components.clean_components(odd, 50, 1.1)
    want, _ = components.clean_components_plain(masks, 50, 1.1)
    assert torch.equal(got, want)


def test_components_stack_of_64(gen):
    """N = 64 at 750^2: every kind, shifted, beside random blob stacks."""
    rest = 64 - 5 * len(MASK_KINDS)
    masks = torch.cat([_stack(k, 5, 750, 750) for k in MASK_KINDS]
                      + [_blob_stack(gen, rest, 750, 750)])
    assert masks.shape == (64, 750, 750)
    got = components.connected_components(masks)
    assert torch.equal(got, components.connected_components_plain(masks))
    kept, _ = components.clean_components(masks, 500, 1.1)
    want, _ = components.clean_components_plain(masks, 500, 1.1)
    assert torch.equal(kept, want)


def test_clean_components_peak_memory(gen):
    """Scratch beyond the labels and the output: one int32 plane's worth
    (the cell table), not five."""
    masks = _blob_stack(gen, 16, 750, 750)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    components.clean_components(masks, 50, 1.1)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    npx = masks.numel()
    assert above <= npx * (4 + 1) + 16 * 376 * 376 * 16 + 2 ** 20


# ---------------------------------------------------------------------------
# multi-scale deformable attention: corners, NaN, edges, levels, points
# ---------------------------------------------------------------------------

LEVELS = ((20, 24), (10, 12), (5, 6), (3, 3), (2, 2), (1, 1), (1, 2), (2, 1))


def _msda_inputs(gen, b, lq, n_levels, n_points, dtype, kind):
    shapes = LEVELS[:n_levels]
    s = sum(h * w for h, w in shapes)
    value = (torch.randn(b, s, 8, 32, generator=gen, device="cuda")
             .to(dtype))
    size = (b, lq, 8, n_levels, n_points)
    if kind == "outside":  # every corner outside its level
        u = torch.rand(*size, 2, generator=gen, device="cuda")
        loc = torch.where(u < 0.5, -0.6 + u * 0.4, 1.2 + u * 0.4)
    elif kind == "edges":  # exactly on pixel centres and level edges
        loc = torch.empty(*size, 2, device="cuda")
        for lvl, (h, w) in enumerate(shapes):
            for c, n in ((0, w), (1, h)):
                choices = torch.tensor(
                    [0.0, 1.0, 0.5 / n, 1 - 0.5 / n, (n + 0.5) / n,
                     -0.5 / n, 1.0 / n, (n - 1.0) / n], device="cuda")
                idx = torch.randint(0, len(choices), size[:3] + (n_points,),
                                    generator=gen, device="cuda")
                loc[:, :, :, lvl, :, c] = choices[idx]
    else:
        loc = torch.rand(*size, 2, generator=gen, device="cuda") * 1.4 - 0.2
    att = torch.softmax(torch.randn(b, lq, 8, n_levels * n_points,
                                    generator=gen, device="cuda"), -1)
    return shapes, value, loc.contiguous(), att.reshape(size).contiguous()


@pytest.mark.parametrize("n_levels,n_points,lq,b,dtype,kind", [
    (4, 4, 900, 1, torch.bfloat16, "uniform"),
    (1, 1, 37, 2, torch.bfloat16, "uniform"),
    (2, 8, 37, 2, torch.bfloat16, "uniform"),
    (8, 4, 101, 1, torch.bfloat16, "uniform"),
    (8, 8, 13, 2, torch.float32, "uniform"),
    (3, 1, 37, 2, torch.float32, "uniform"),
    (4, 4, 1, 1, torch.float32, "uniform"),
    (5, 4, 64, 2, torch.bfloat16, "outside"),
    (4, 4, 37, 2, torch.bfloat16, "nan"),
    (7, 1, 200, 1, torch.float32, "nan"),
    (4, 8, 37, 2, torch.float32, "edges"),
    (6, 4, 37, 2, torch.bfloat16, "edges")])
def test_ms_deform_attn_cases(gen, n_levels, n_points, lq, b, dtype, kind):
    """Lq not a multiple of a block's 8 queries, 1 to 8 levels, 1, 4 and 8
    points, fp32 and bf16 values, B = 2; a NaN location contributes zero,
    as one outside every level does."""
    shapes, value, loc, att = _msda_inputs(gen, b, lq, n_levels, n_points,
                                           dtype, kind)
    before = _kernels.LAUNCHES["ms_deform_attn"]
    if kind == "nan":  # x, y or both NaN at 30% of the points
        which = torch.randint(0, 10, loc.shape[:-1], generator=gen,
                              device="cuda")
        loc_ref = torch.where((which < 3)[..., None], -10.0, loc)
        loc = loc.clone()
        nan = float("nan")
        loc[..., 0] = torch.where((which == 0) | (which == 2), nan,
                                  loc[..., 0])
        loc[..., 1] = torch.where((which == 1) | (which == 2), nan,
                                  loc[..., 1])
    else:
        loc_ref = loc
    got = deformable.ms_deform_attn(value, shapes, loc, att)
    assert _kernels.LAUNCHES["ms_deform_attn"] == before + 1
    want = deformable.ms_deform_attn_plain(value.float(), shapes, loc_ref,
                                           att)
    assert got.dtype == dtype and got.shape == (b, lq, 256)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=2e-2)
    if kind == "outside":
        assert not got.any()


# ---------------------------------------------------------------------------
# multi-scale deformable attention at GroundingDINO's batch of 2 and 4
# images (the batched sweep): the 800^2 bucket's levels, 4 x 4 points
# ---------------------------------------------------------------------------

GDINO_LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("lq", [13294, 900])
def test_ms_deform_attn_gdino_batch(gen, b, lq):
    """The encoder's raster queries (Lq 13294, K5t) and the decoder's 900
    (K5f) of b images in one launch."""
    s = sum(h * w for h, w in GDINO_LEVELS)
    value = _randn(gen, b, s, 8, 32)
    loc = (torch.rand(b, lq, 8, 4, 4, 2, generator=gen, device="cuda")
           * 1.2 - 0.1)
    att = torch.softmax(torch.randn(b, lq, 8, 16, generator=gen,
                                    device="cuda"), -1).reshape(b, lq, 8, 4, 4)
    before = _kernels.LAUNCHES["ms_deform_attn"]
    got = deformable.ms_deform_attn(value, GDINO_LEVELS, loc, att)
    assert _kernels.LAUNCHES["ms_deform_attn"] == before + 1
    want = deformable.ms_deform_attn_plain(value.float(), GDINO_LEVELS, loc,
                                           att)
    assert got.shape == (b, lq, 256)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the 3x3 NHWC convolution (scripts/ablate_pallas_conv.py's levels at batch
# 2, and edge cases: Cout != C, C and Cout not multiples of the 64-channel
# slab or the 64-column weight box, patches past the image's bottom and
# right edges, a tile with one patch, split tails, 1-pixel images; which
# case reaches which is held on the CPU, tests/test_torch_conv.py)
# ---------------------------------------------------------------------------

CONV_LEVELS = [(2, 96, 96, 320, 320), (2, 48, 48, 640, 640),
               (2, 24, 24, 1280, 1280), (2, 12, 12, 1280, 1280)]


@pytest.mark.parametrize("b,h,w,c,cout", CONV_LEVELS + [
    (1, 10, 14, 48, 64), (2, 12, 12, 32, 32), (3, 7, 5, 8, 136),
    (1, 1, 1, 16, 8), (1, 1, 9, 24, 40), (2, 33, 17, 72, 200),
    (3, 23, 22, 64, 96), (2, 20, 18, 200, 136), (1, 9, 9, 136, 72)])
def test_conv3x3_kernel(gen, b, h, w, c, cout):
    x = _randn(gen, b, h, w, c)
    wt = _randn(gen, 3, 3, c, cout, std=(9 * c) ** -0.5)
    before = _kernels.LAUNCHES["conv3x3"]
    got = conv.conv3x3_nhwc(x, wt)
    assert _kernels.LAUNCHES["conv3x3"] == before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == torch.bfloat16
    want = conv.conv3x3_nhwc_plain(x.float(), wt.float())
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    assert _rel_l2(got, want) <= 5e-3


def test_conv3x3_matches_cudnn(gen):
    """The same function as F.conv2d on the NCHW views (TF32 off)."""
    x = _randn(gen, 2, 24, 20, 64)
    wt = _randn(gen, 3, 3, 64, 48, std=(9 * 64) ** -0.5)
    got = conv.conv3x3_nhwc(x, wt)
    want = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    assert _rel_l2(got, want) <= 5e-3


@pytest.mark.parametrize("level", [0, 2, 3])
def test_conv3x3_split_is_bit_identical(gen, level):
    """Levels whose tail tiles are split (level 0: 24 of 288 tiles;
    levels 2 and 3: all): two calls give the same bits, the partials
    being added in split order."""
    b, h, w, c, cout = CONV_LEVELS[level]
    assert conv.conv_config(b, h, w, c, cout,
                            _kernels.sm_count(0)).splits > 1
    x = _randn(gen, b, h, w, c)
    wt = _randn(gen, 3, 3, c, cout, std=(9 * c) ** -0.5)
    first = conv.conv3x3_nhwc(x, wt)
    assert torch.equal(first, conv.conv3x3_nhwc(x, wt))


def test_conv3x3_level3_matches_cudnn(gen):
    """Level 3 (6 splits of each tile's K) against F.conv2d in fp32 with
    TF32 off."""
    b, h, w, c, cout = CONV_LEVELS[3]
    x = _randn(gen, b, h, w, c)
    wt = _randn(gen, 3, 3, c, cout, std=(9 * c) ** -0.5)
    got = conv.conv3x3_nhwc(x, wt)
    want = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    assert _rel_l2(got, want) <= 5e-3


def test_conv3x3_refuses_what_the_kernel_does_not_take(gen):
    x = _randn(gen, 1, 8, 8, 16)
    wt = _randn(gen, 3, 3, 16, 16)
    with pytest.raises(TypeError):
        conv.conv3x3_nhwc(x.float(), wt.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        conv.conv3x3_nhwc(_randn(gen, 1, 8, 8, 12), _randn(gen, 3, 3, 12, 16))
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv3x3_nhwc(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match=r"\(3, 3, C, Cout\)"):
        conv.conv3x3_nhwc(x, _randn(gen, 1, 1, 16, 16))
    with pytest.raises(ValueError, match="mixed devices"):
        conv.conv3x3_nhwc(x, wt.cpu())
    buf = _randn(gen, 1 + 8 * 8 * 16)
    with pytest.raises(ValueError, match="aligned"):
        conv.conv3x3_nhwc(buf[1:].view(1, 8, 8, 16), wt)


# SDXL at 1024^2 with CFG batch 2: self-attention over 64^2 tokens with 10
# heads (level 1) and 32^2 with 20 heads (level 2), head_dim 64; the
# transformer LayerNorms at (2 * 64^2, 640) and (2 * 32^2, 1280)
@pytest.mark.parametrize("bh,n", [(20, 4096), (40, 1024)])
def test_flash_attention_sdxl_shapes(gen, bh, n):
    q, k, v = (_randn(gen, bh, n, 64) for _ in range(3))
    got = attention.flash_attention(q, k, v)
    want = attention.flash_attention_plain(*_f32([q, k, v]), 64 ** -0.5)
    torch.testing.assert_close(got.float(), want, **TOL)
    assert _rel_l2(got, want) <= 5e-3


@pytest.mark.parametrize("rows,c", [(8192, 640), (2048, 1280)])
def test_layernorm_sdxl_shapes(gen, rows, c):
    x = _randn(gen, rows, c)
    sc, bi = 1 + _randn(gen, c, std=0.1), _randn(gen, c, std=0.1)
    torch.testing.assert_close(norm.layernorm_2d(x, sc, bi).float(),
                               norm.layernorm_2d_plain(*_f32([x, sc, bi])),
                               **TOL)


def test_sdxl_generate_launches_its_kernels(gen):
    """A narrow SDXL pipeline on the card (blocks (64, 64, 64), depths
    (0, 2, 2), head_dim 64, a 512^2 image: 64^2 latents): per UNet forward
    the 10 self-attentions of level 1 (32^2 = 1024 tokens) take the flash
    kernel and level 2's 256 tokens take sdpa; the LayerNorms of all 22
    basic blocks (2048 and 512 rows) take the kernel.  Two steps."""
    from PIL import Image

    from inklayer_tpu_torch.build import build_sdxl_models
    from inklayer_tpu_torch.models.diffusion.sdxl import (SDXLConfig,
                                                          SDXLInpaintPipeline)

    cfg = SDXLConfig(resolution=512, num_steps=2, block_channels=(64, 64, 64),
                     transformer_layers=(0, 2, 2), context_dim=128,
                     pooled_dim=64, vae_channels=(8, 8, 8, 8),
                     text_l_hidden=64, text_g_hidden=64, text_l_layers=2,
                     text_g_layers=2)
    pipe = SDXLInpaintPipeline(build_sdxl_models(cfg, "cuda", torch.bfloat16),
                               cfg)
    image = Image.new("RGB", (300, 200), "white")
    mask = Image.new("L", (300, 200), 0)
    mask.paste(255, (50, 40, 200, 150))
    _kernels.reset_launch_counts()
    out = pipe.generate(image, mask)
    counts = _kernels.launch_counts()
    assert out.size == image.size
    assert counts.get("flash_attention/d64", 0) == 10 * 2
    assert counts.get("layernorm", 0) == 3 * 22 * 2
    assert pipe.stage_times["steps"] == 2


# the SAM mask prompt's LN(16): B x 64^2 rows of 16 channels (2 lanes a
# row) at the decode batches of one prompt, a point batch and the default
# run's capacity; and the whole mask convnet on the card against the CPU
@pytest.mark.parametrize("b", [1, 4, 64])
def test_layernorm_mask_prompt_shape(gen, b):
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn(gen, b * 4096, 16).to(dtype)
        sc = (1 + _randn(gen, 16, std=0.1)).to(dtype)
        bi = _randn(gen, 16, std=0.1).to(dtype)
        before = _kernels.LAUNCHES["layernorm"]
        got = norm.layernorm_2d(x, sc, bi)
        assert _kernels.LAUNCHES["layernorm"] == before + 1
        torch.testing.assert_close(
            got.float(), norm.layernorm_2d_plain(*_f32([x, sc, bi])), **TOL)


def test_mask_prompt_convnet_launches_layernorm_once(gen):
    from inklayer_tpu_torch.models.sam.prompt_encoder import PromptEncoder

    torch.manual_seed(0)
    pe = PromptEncoder()
    for p in pe.parameters():
        p.data.normal_(0, 0.5)
    masks = torch.randn(2, 256, 256, 1, generator=gen, device="cuda")
    want = pe.embed_masks(masks.cpu())
    pe = pe.cuda()
    before = _kernels.LAUNCHES["layernorm"]
    with torch.inference_mode():
        got = pe.embed_masks(masks)
    # LN(16) over 2 x 64^2 rows launches; LN(4) takes the plain version
    assert _kernels.LAUNCHES["layernorm"] == before + 1
    torch.testing.assert_close(got.cpu(), want.detach(), atol=1e-3, rtol=1e-3)


def test_bench_workload_launches_its_kernels(gen):
    """Exact launches of one full-width detect+segment call of the bench,
    the table chip_smoke.py derives (``BENCH_LAUNCHES``)."""
    from chip_smoke import BENCH_LAUNCHES
    from inklayer_tpu_torch import bench

    fn, g, s, img = bench.build_workload()
    fn(g, s, img).item()  # warm: the first call builds the library
    _kernels.reset_launch_counts()
    value = fn(g, s, img).item()
    counts = {k: c for k, c in _kernels.launch_counts().items() if c}
    assert counts == BENCH_LAUNCHES
    assert torch.isfinite(torch.tensor(value))


# ---------------------------------------------------------------------------
# Depth-Anything-V2's forward replayed from a CUDA graph (DepthEstimator)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def depth_model():
    """Full-width ViT-B (the default DepthConfig) in bf16 on the card:
    weights N(0, 0.02), biases 0, norm scales and LayerScale 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from inklayer_tpu_torch.models.depth import DepthAnythingV2

    g = torch.Generator(device="cuda").manual_seed(0)
    model = DepthAnythingV2().to("cuda").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
            else:
                p.fill_(0.0 if name.endswith("bias") else 1.0)
    return model.to(torch.bfloat16)


def _sketch(seed, hw):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (*hw, 3), generator=g, device="cuda",
                         dtype=torch.uint8)


def _eager_map(est, image):
    """The estimator's map with its forward held eager (a hook)."""
    handle = est.model.register_forward_hook(lambda *a: None)
    try:
        assert not est.replayable()
        return est.infer_image_device(image)
    finally:
        handle.remove()


@pytest.mark.parametrize("hw", [(750, 750), (750, 1100)])
def test_depth_graph_replays_the_eager_map_bit_for_bit(gen, depth_model, hw):
    """518^2 and the (518, 798) bucket (which resamples the position
    embedding): the eager first call, the capturing second and two
    replays give one map."""
    from inklayer_tpu_torch.models.depth import DepthEstimator

    est = DepthEstimator(depth_model)
    image = _sketch(1, hw)
    maps = [est.infer_image_device(image) for _ in range(4)]
    torch.cuda.synchronize()
    assert maps[0].shape == hw and float(maps[0].abs().max()) > 0
    for m in maps[1:]:
        assert torch.equal(m, maps[0])
    assert torch.equal(_eager_map(est, image), maps[0])


def test_depth_graph_replays_count_the_eager_launches(gen, depth_model):
    from inklayer_tpu_torch.models.depth import DepthEstimator

    est = DepthEstimator(depth_model)
    image = _sketch(2, (750, 750))

    def counted(calls):
        before = _kernels.launch_counts()
        for _ in range(calls):
            est.infer_image_device(image)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        return {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}

    eager = counted(1)
    assert eager == {"flash_attention": 12, "flash_attention/d64": 12,
                     "layernorm": 28}
    assert counted(1) == eager  # the capture and its replay
    for k in (1, 3):
        assert counted(k) == {key: k * n for key, n in eager.items()}


def test_depth_graph_two_threads_on_two_streams(gen, depth_model):
    """Two callers on their own threads and streams, each with its own
    sketch, replay one graph in turns: each gets its own map."""
    import sys
    import threading

    from inklayer_tpu_torch.models.depth import DepthEstimator

    est = DepthEstimator(depth_model)
    images = [_sketch(3, (750, 750)), _sketch(4, (750, 750))]
    want = [_eager_map(est, im) for im in images]
    assert not torch.equal(want[0], want[1])
    for im in images:  # eager, then the capture
        est.infer_image_device(im)
    got, errors = [[], []], []

    def caller(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(10):
                    got[i].append(est.infer_image_device(images[i]))
                stream.synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for i in range(2):
        assert len(got[i]) == 10
        assert all(torch.equal(m, want[i]) for m in got[i])


def test_depth_spans_count_graphed(gen, depth_model):
    from torch.profiler import ProfilerActivity, profile

    from inklayer_tpu_torch import spans
    from inklayer_tpu_torch.models.depth import DepthEstimator

    est = DepthEstimator(depth_model)
    image = _sketch(5, (750, 750))
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            est.infer_image_device(image)
        torch.cuda.synchronize()
    graphed = [r.counts.get("graphed") for r in spans.take()
               if r.name == "depth"]
    assert graphed == [0, 0, 1]
