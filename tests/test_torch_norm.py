"""Port parity: LayerNorm and the fused residual LayerNorm
(inklayer_tpu_torch.ops.norm / nn.layers.LayerNorm) against the JAX
package's Pallas kernels in interpret mode and its XLA path.

Tolerances: fp32 paths atol = rtol = 1e-4 per op; bf16 paths rtol 2e-2.
Also the CUDA kernel's launch configuration (``layernorm_config``), which
is plain Python.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.nn.layers import LayerNorm as JaxLayerNorm
from inklayer_tpu.ops.norm import layernorm_2d, layernorm_residual_2d
from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.ops.norm import (LN_VECTORS, layernorm_config,
                                         layernorm_2d as t_layernorm_2d,
                                         layernorm_residual_2d as t_ln_res)

F32 = dict(atol=1e-4, rtol=1e-4)


def _inputs(rng, rows, c):
    x = (rng.standard_normal((rows, c)) * 2 + 0.5).astype(np.float32)
    y = rng.standard_normal((rows, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, y, scale, bias


@pytest.mark.parametrize("rows,c", [(512, 96), (600, 256), (64, 1280)])
def test_layernorm_plain_matches_pallas_interpret(rng, rows, c):
    x, _, scale, bias = _inputs(rng, rows, c)
    want = layernorm_2d(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        interpret=True)
    got = t_layernorm_2d(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("rows,c", [(512, 192), (700, 1280)])
def test_layernorm_residual_plain_matches_pallas_interpret(rng, rows, c):
    x, y, scale, bias = _inputs(rng, rows, c)
    s_want, o_want = layernorm_residual_2d(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias),
        interpret=True)
    s_got, o_got = t_ln_res(torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), **F32)
    np.testing.assert_allclose(o_got.numpy(), np.asarray(o_want), **F32)


@pytest.mark.parametrize("shape,eps", [((2, 300, 64), 1e-6),
                                       ((1024, 96), 1e-6),
                                       ((3, 5, 16), 1e-12)])
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_module_matches_xla_path(rng, shape, eps, residual):
    """The module (gate rows >= 512 and C % 8 == 0, else plain) against the
    flax LayerNorm on the CPU backend (the XLA path), same params."""
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jm = JaxLayerNorm(eps=eps)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    tm = LayerNorm(c, eps=eps)
    tm.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        if residual:
            want = jm.apply(params, jnp.asarray(x), jnp.asarray(y))
            got = tm(torch.from_numpy(x), torch.from_numpy(y))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
        else:
            want = jm.apply(params, jnp.asarray(x))
            got = tm(torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_layernorm_bf16_matches_pallas_interpret(rng):
    """bf16 activations, fp32 statistics on both sides (rtol 2e-2)."""
    x, y, scale, bias = _inputs(rng, 512, 128)
    jx, jy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    s_want, o_want = layernorm_residual_2d(
        jx, jy, jnp.asarray(scale), jnp.asarray(bias), interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    s_got, o_got = t_ln_res(tx, ty, torch.from_numpy(scale),
                            torch.from_numpy(bias))
    assert s_got.dtype == o_got.dtype == torch.bfloat16
    np.testing.assert_allclose(s_got.float().numpy(),
                               np.asarray(s_want, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(o_got.float().numpy(),
                               np.asarray(o_want, np.float32),
                               atol=2e-2, rtol=2e-2)


# The kernel's launch configuration (a pure function): lanes per row,
# 16-byte vectors per lane, threads per block.
@pytest.mark.parametrize("c,lanes,vpl", [(96, 4, 3), (256, 32, 1),
                                         (320, 8, 5), (640, 16, 5),
                                         (768, 32, 3), (1280, 32, 5),
                                         (4096, 32, 16)])
def test_layernorm_config_no_lane_idles(c, lanes, vpl):
    """bf16: every lane of a row's group holds the same number of vectors,
    and the instance holds exactly that many."""
    got_lanes, got_vpl, threads = layernorm_config(4096, c, 2)
    assert (got_lanes, got_vpl) == (lanes, vpl)
    assert lanes * vpl * 8 == c and 32 % lanes == 0
    assert vpl in LN_VECTORS and threads in (32, 64, 128, 256)


@pytest.mark.parametrize("rows,c,threads", [
    (4096, 1280, 256), (40000, 96, 256), (1370, 768, 128),
    (18432, 320, 256), (4608, 640, 256), (1152, 1280, 128), (513, 96, 32)])
def test_layernorm_config_blocks_fill_the_card(rows, c, threads):
    """chip_smoke's shapes (and a last group left partly empty): blocks
    shrink until the grid holds two per SM of 132, or to one warp."""
    lanes, _, got = layernorm_config(rows, c, 2)
    assert got == threads
    blocks = -(-rows * lanes // got)
    assert blocks >= 2 * 132 or got == 32
    if got < 256:
        assert -(-rows * lanes // (2 * got)) < 2 * 132


def test_layernorm_config_uneven_rows_take_the_whole_warp():
    """C 272 (34 vectors): no power of two gives <= 16 per lane, so the row
    takes 32 lanes with the last vectors guarded; fp32 counts 4 a vector,
    and a share with no instance (10) takes the next one up (16)."""
    assert layernorm_config(512, 272, 2)[:2] == (32, 2)
    assert layernorm_config(512, 1280, 4)[:2] == (32, 16)
    assert layernorm_config(512, 96, 4)[:2] == (8, 3)


@pytest.mark.parametrize("c,element_size", [(100, 2), (1284, 2), (6, 4),
                                            (0, 2), (4104, 2), (4096, 4)])
def test_layernorm_config_refuses(c, element_size):
    """C not a multiple of a 16-byte vector, or wider than 16 vectors on
    each of 32 lanes."""
    with pytest.raises(ValueError):
        layernorm_config(512, c, element_size)
