"""Port parity: attention ops (inklayer_tpu_torch.ops.attention) against
the JAX package: sdpa, the rel-term helpers, the plain rel-pos attention
against the Pallas SAM kernels in interpret mode
(sam_window_block_attention, sam_global_attention2, sam_global_attention
for a kh = kw != 64 grid, sam_window_attention on partitioned windows, and
flash_attention with rel_h/rel_w), and the plain flash attention against
the Pallas ``flash_attention`` in interpret mode.

Tolerances: fp32 ops atol = rtol = 1e-4; the flash attention atol 2e-5 in
fp32; kernels that round operands to bf16 inside (the window kernel's aug
matmul, sam_global_attention's bf16 rel expansion) at bf16 tolerance
atol = rtol = 2e-2.  sam_window_attention rounds its rel terms to bf16 too;
its test draws them bf16-exact, so it holds to the fp32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.models.sam.image_encoder import _gather_rel_pos, _rel_term
from inklayer_tpu.ops.attention import (attention, flash_attention,
                                        sam_global_attention,
                                        sam_global_attention2,
                                        sam_window_attention,
                                        sam_window_block_attention, sdpa)
from inklayer_tpu_torch.ops import attention as T

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_sdpa_matches_jax_with_bias_and_mask(rng):
    q = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    bias = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    mask = rng.random((2, 1, 5, 7)) > 0.3
    mask[..., 0] = True
    want = sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                bias=jnp.asarray(bias), mask=jnp.asarray(mask), scale=0.3)
    got = T.sdpa(_t(q), _t(k), _t(v), bias=_t(bias),
                 mask=torch.from_numpy(mask), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("size", [4, 14])
def test_gather_rel_pos_and_rel_terms_match_jax(rng, size):
    table_h = rng.standard_normal((2 * size - 1, 8)).astype(np.float32)
    table_w = rng.standard_normal((2 * size - 1, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        T.gather_rel_pos(_t(table_h), size, size).numpy(),
        np.asarray(_gather_rel_pos(jnp.asarray(table_h), size, size)))
    q = rng.standard_normal((2, 3, size, size, 8)).astype(np.float32)
    want_h = _rel_term(jnp.asarray(q), jnp.asarray(table_h), 2)
    want_w = _rel_term(jnp.asarray(q), jnp.asarray(table_w), 3)
    got_h, got_w = T.rel_terms(_t(q), _t(table_h), _t(table_w))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **F32)


def test_resize_rel_table_matches_jax(rng):
    from inklayer_tpu.models.sam.image_encoder import _resize_rel_table

    table = rng.standard_normal((27, 8)).astype(np.float32)
    want = _resize_rel_table(jnp.asarray(table), 8, 8)  # 27 -> 15 rows
    np.testing.assert_allclose(T.resize_rel_table(_t(table), 8, 8).numpy(),
                               np.asarray(want), **F32)


def test_relpos_plain_matches_window_block_kernel(rng):
    """Windows of a spatial qkv map: the port partitions them and runs the
    plain rel-pos attention; the JAX kernel addresses them in place."""
    win, heads, hd, g = 8, 2, 16, 2
    c = heads * hd
    hp = g * win
    n = win * win
    qkv_sp = rng.standard_normal((1, hp, hp, 3 * c)).astype(np.float32)
    rel_pos_h = (rng.standard_normal((2 * win - 1, hd)) * 0.3).astype(np.float32)
    rel_pos_w = (rng.standard_normal((2 * win - 1, hd)) * 0.3).astype(np.float32)
    tab_h = _gather_rel_pos(jnp.asarray(rel_pos_h), win, win)
    tab_w = _gather_rel_pos(jnp.asarray(rel_pos_w), win, win)
    scale = hd ** -0.5
    want = sam_window_block_attention(
        jnp.asarray(qkv_sp), tab_h, tab_w, scale=scale, win=win, heads=heads,
        head_dim=hd, interpret=True)
    want = np.asarray(want).reshape(1, g, win, g, win, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(g * g, n, heads, hd).transpose(0, 2, 1, 3)

    win_qkv = qkv_sp.reshape(1, g, win, g, win, 3, heads, hd).transpose(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, g * g * heads, win, win, hd)
    q, k, v = (_t(a) for a in win_qkv)
    rel_h, rel_w = T.rel_terms(q, _t(rel_pos_h), _t(rel_pos_w))
    got = T.relpos_attention(
        q.reshape(-1, n, hd), k.reshape(-1, n, hd), v.reshape(-1, n, hd),
        rel_h.reshape(-1, n, win), rel_w.reshape(-1, n, win), scale)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, **BF16)


def _global_case(rng, heads, kh, hd):
    n = kh * kh
    q, k, v = (rng.standard_normal((heads, n, hd)).astype(np.float32)
               for _ in range(3))
    rh, rw = (rng.standard_normal((heads, n, kh)).astype(np.float32)
              for _ in range(2))
    return q, k, v, rh, rw


def _pack128(t, hd):
    heads, n, _ = t.shape
    p = np.pad(t, ((0, 0), (0, 0), (0, 128 - hd)))
    return jnp.asarray(p.transpose(1, 0, 2).reshape(n, heads * 128))


def test_relpos_plain_matches_global_attention2(rng):
    heads, kh, hd = 2, 8, 80
    q, k, v, rh, rw = _global_case(rng, heads, kh, hd)
    n, scale = kh * kh, hd ** -0.5
    out2 = sam_global_attention2(
        _pack128(q, hd), _pack128(k, hd), _pack128(v, hd),
        jnp.asarray(rh.transpose(1, 0, 2)), jnp.asarray(rw.transpose(1, 0, 2)),
        scale=scale, kh=kh, kw=kh, heads=heads, block_q=32, interpret=True)
    want = np.asarray(out2).reshape(n, heads, 128)[..., :hd].transpose(1, 0, 2)
    got = T.relpos_attention(_t(q), _t(k), _t(v), _t(rh), _t(rw), scale)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_relpos_plain_matches_global_attention_other_grid(rng):
    """kh = kw = 6: the in-kernel aug fallback (SAM inputs other than
    1024^2), whose rel expansion runs in bf16."""
    heads, kh, hd = 2, 6, 80
    q, k, v, rh, rw = _global_case(rng, heads, kh, hd)
    n, scale = kh * kh, hd ** -0.5
    out2 = sam_global_attention(
        _pack128(q, hd), _pack128(k, hd), _pack128(v, hd), jnp.asarray(rh),
        jnp.asarray(rw), scale=scale, kh=kh, kw=kh, heads=heads, block_q=12,
        interpret=True)
    want = np.asarray(out2).reshape(n, heads, 128)[..., :hd].transpose(1, 0, 2)
    got = T.relpos_attention(_t(q), _t(k), _t(v), _t(rh), _t(rw), scale)
    np.testing.assert_allclose(got.numpy(), want, **BF16)


@pytest.mark.parametrize("kh,kw,hd", [(8, 8, 32), (6, 10, 80)])
def test_relpos_plain_matches_flash_relpos_kernel(rng, kh, kw, hd):
    """flash_attention with rel_h/rel_w (the Pallas _flash_relpos_kernel,
    whole K/V resident, rel bias expanded by 0/1 matmuls) is the port's
    relpos_attention on the same (BH, N, D) layout."""
    bh, n = 2, kh * kw
    q, k, v = (rng.standard_normal((bh, n, hd)).astype(np.float32)
               for _ in range(3))
    rh = rng.standard_normal((bh, n, kh)).astype(np.float32)
    rw = rng.standard_normal((bh, n, kw)).astype(np.float32)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           rel_h=jnp.asarray(rh), rel_w=jnp.asarray(rw),
                           kh=kh, kw=kw, block_q=32, interpret=True)
    got = T.relpos_attention(_t(q), _t(k), _t(v), _t(rh), _t(rw),
                             hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def test_relpos_plain_matches_window_attention_kernel(rng):
    """sam_window_attention takes the qkv dense output per window, (nw, n,
    3 * heads * hd), and head-blocked rel terms, (nw, n, heads * kh|kw);
    un-packed to (nw * heads, n, ...) they are the port's relpos_attention
    inputs.  kh != kw; the kernel rounds the rel terms to bf16, so they are
    drawn bf16-exact."""
    nw, heads, hd, kh, kw = 3, 2, 16, 7, 9
    n, c = kh * kw, heads * hd
    qkv = rng.standard_normal((nw, n, 3 * c)).astype(np.float32)
    rh = _bf16_exact(rng.standard_normal((nw, n, heads * kh)).astype(
        np.float32))
    rw = _bf16_exact(rng.standard_normal((nw, n, heads * kw)).astype(
        np.float32))
    scale = hd ** -0.5
    want = sam_window_attention(jnp.asarray(qkv), jnp.asarray(rh),
                                jnp.asarray(rw), scale=scale, kh=kh, kw=kw,
                                heads=heads, head_dim=hd, interpret=True)

    def heads_first(a, width):  # (nw, n, heads * width) -> (nw*heads, n, w)
        return _t(a.reshape(nw, n, heads, width).transpose(0, 2, 1, 3)
                  .reshape(nw * heads, n, width))

    q, k, v = (heads_first(qkv[..., i * c:(i + 1) * c], hd) for i in range(3))
    got = T.relpos_attention(q, k, v, heads_first(rh, kh),
                             heads_first(rw, kw), scale)
    got = got.numpy().reshape(nw, heads, n, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.reshape(nw, n, c), np.asarray(want), **F32)


def test_relpos_attention_refuses_bad_tiling():
    """The CPU path is the plain version; the shape contract still holds
    there through the bias reshape."""
    q = torch.zeros(1, 12, 16)
    with pytest.raises(RuntimeError):
        T.relpos_attention(q, q, q, torch.zeros(1, 12, 3), torch.zeros(1, 12, 5),
                           0.25)


@pytest.mark.parametrize("bh,n", [(2, 300), (2, 1370)])
def test_flash_plain_matches_pallas_flash_kernel(rng, bh, n):
    """1370 = 21 * 64 + 26: the Pallas kernel pads the keys to 1408 and
    masks the tail (nk_valid); the plain version sees no padding."""
    q, k, v = (rng.standard_normal((bh, n, 64)).astype(np.float32)
               for _ in range(3))
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           interpret=True)
    got = T.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_flash_plain_masks_tail_keys(rng):
    """50 keys: the Pallas kernel pads them to 128 and masks the 78-key
    tail; the plain version is given the 50 keys alone."""
    q = rng.standard_normal((2, 70, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 50, 64)).astype(np.float32)
            for _ in range(2))
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale=0.125, interpret=True)
    got = T.flash_attention_plain(_t(q), _t(k), _t(v), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("bh,n,d", [(2, 100, 40), (2, 70, 80),
                                    (3, 1030, 40)])
def test_flash_plain_matches_pallas_flash_kernel_unet_head_dims(rng, bh, n,
                                                                d):
    """The UNet's head dims: 40 (level 0, which the CUDA kernel pads to
    48) and 80 (level 1); the Pallas kernel pads both to 128 lanes."""
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
               for _ in range(3))
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           interpret=True)
    got = T.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_attention_dispatcher_at_head_dim_40_matches_pallas_flash(rng):
    """(B, H, N, D) = (1, 2, 1030, 40): >= 1024 keys, so the dispatcher
    folds the heads into the flash op, as the UNet's self-attention."""
    q, k, v = (rng.standard_normal((1, 2, 1030, 40)).astype(np.float32)
               for _ in range(3))
    fold = lambda a: jnp.asarray(a.reshape(2, 1030, 40))
    want = flash_attention(fold(q), fold(k), fold(v), interpret=True)
    got = T.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy().reshape(2, 1030, 40),
                               np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [100, 1030])
def test_attention_dispatcher_matches_jax(rng, n):
    """(B, H, N, D): >= 1024 keys take the flash op, shorter sdpa."""
    q, k, v = (rng.standard_normal((1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    want = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = T.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
