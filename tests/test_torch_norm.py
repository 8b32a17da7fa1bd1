"""Port parity: LayerNorm and the fused residual LayerNorm
(inklayer_tpu_torch.ops.norm / nn.layers.LayerNorm) against the JAX
package's Pallas kernels in interpret mode and its XLA path.

Tolerances: fp32 paths atol = rtol = 1e-4 per op; bf16 paths rtol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.nn.layers import LayerNorm as JaxLayerNorm
from inklayer_tpu.ops.norm import layernorm_2d, layernorm_residual_2d
from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.ops.norm import (layernorm_2d as t_layernorm_2d,
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
