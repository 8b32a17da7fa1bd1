"""Port parity: the SAM MLP fc1 -> exact GELU -> fc2
(inklayer_tpu_torch.ops.mlp.mlp_gelu and nn.layers.MLP) against the JAX
package's Pallas mlp_gelu in interpret mode (bf16) and its XLA MLP (fp32).

Tolerances: bf16 kernel path rtol 2e-2; fp32 XLA path atol = rtol = 1e-4;
the TPU kernel's polynomial erf against torch's exact erf GELU 1e-5.  Also
the CUDA GEMM's launch configuration (``gemm_config``), which is plain
Python.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inklayer_tpu.nn.layers import MLP as JaxMLP
from inklayer_tpu.ops.mlp import _gelu, mlp_gelu
from inklayer_tpu_torch.nn.layers import MLP
from inklayer_tpu_torch.ops.mlp import GEMM_BLOCK_N, gemm_config
from inklayer_tpu_torch.ops.mlp import mlp_gelu as t_mlp_gelu


def _weights(rng, c, hid):
    w1 = (rng.standard_normal((c, hid)) * c ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(hid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((hid, c)) * hid ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("t,c,hid", [(512, 128, 512), (1024, 256, 1024)])
def test_mlp_gelu_bf16_matches_pallas_interpret(rng, t, c, hid):
    x = rng.standard_normal((t, c)).astype(np.float32)
    w1, b1, w2, b2 = (_bf16(a) for a in _weights(rng, c, hid))
    x = _bf16(x)
    want = mlp_gelu(*(jnp.asarray(a, jnp.bfloat16)
                      for a in (x, w1, b1, w2, b2)), interpret=True)
    # the port takes nn.Linear's (out, in) weight layout
    got = t_mlp_gelu(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16) for a in (x, w1.T, b1, w2.T, b2)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_mlp_module_fp32_matches_xla_mlp(rng):
    c, hid = 64, 256
    x = rng.standard_normal((2, 50, c)).astype(np.float32)
    w1, b1, w2, b2 = _weights(rng, c, hid)
    params = {"params": {"fc1": {"kernel": w1, "bias": b1},
                         "fc2": {"kernel": w2, "bias": b2}}}
    want = JaxMLP(hid, c).apply(params, jnp.asarray(x))
    tm = MLP(c, hid, c, fused=True)
    tm.load_state_dict({"lin1.weight": torch.from_numpy(w1.T.copy()),
                        "lin1.bias": torch.from_numpy(b1),
                        "lin2.weight": torch.from_numpy(w2.T.copy()),
                        "lin2.bias": torch.from_numpy(b2)})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_mlp_module_bf16_gate_takes_fused_op(rng, monkeypatch):
    """Shapes inside the JAX gate (bf16, C and out % 128, hidden % 512,
    tokens % 512) go through ops.mlp.mlp_gelu; others do not."""
    import inklayer_tpu_torch.nn.layers as L

    calls = []
    real = L.mlp_gelu
    monkeypatch.setattr(L, "mlp_gelu",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tm = MLP(128, 512, 128, fused=True).to(torch.bfloat16)
    with torch.no_grad():
        tm(torch.zeros(2, 256, 128, dtype=torch.bfloat16))
        tm(torch.zeros(2, 100, 128, dtype=torch.bfloat16))  # tokens % 512
        tm.float()(torch.zeros(2, 256, 128))                 # fp32
    assert calls == [(512, 128)]


def test_erf_polynomial_matches_exact_gelu():
    h = np.linspace(-8, 8, 20001).astype(np.float32)
    poly = np.asarray(_gelu(jnp.asarray(h), "erf"))
    exact = F.gelu(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(poly, exact, atol=1e-5, rtol=1e-5)


# The GEMM's launch configuration (a pure function of the shape and the
# card's SM count): block tile N, output tiles, grid.  fc1 and fc2 at SAM
# ViT-H (T 4096, C 1280, H 5120), the card test's K-128 product, and fc1 at
# 1024 tokens; 132 SMs (H100 SXM).
@pytest.mark.parametrize("shape,want", [
    ((4096, 5120, 1280), (256, 640, 132)),   # 4.85 waves; 160 and 128 tie
    ((4096, 1280, 5120), (160, 256, 132)),   # 1.94 waves (256: 1.21)
    ((512, 512, 128), (128, 16, 16)),        # one partial wave
    ((1024, 5120, 1280), (160, 256, 132)),   # 1.94 waves (256: 1.21)
])
def test_gemm_config_tile_and_grid(shape, want):
    assert gemm_config(*shape) == want


@pytest.mark.parametrize("shape", [(4096, 5120, 1280), (4096, 1280, 5120),
                                   (512, 512, 128), (1024, 5120, 1280),
                                   (1024, 1280, 5120), (512, 384, 96)])
def test_gemm_config_takes_the_least_work_per_sm(shape):
    """The chosen width divides N and has the least ceil(tiles / SMs) *
    width of the instances; a tie goes to the wider tile."""
    m, n, k = shape
    bn, tiles, grid = gemm_config(m, n, k)
    assert bn in GEMM_BLOCK_N and n % bn == 0
    assert tiles == (m // 128) * (n // bn) and grid == min(tiles, 132)
    work = {w: -(-(m // 128) * (n // w) // 132) * w for w in GEMM_BLOCK_N
            if n % w == 0}
    assert work[bn] == min(work.values())
    assert bn == max(w for w, v in work.items() if v == work[bn])


@pytest.mark.parametrize("shape", [(100, 512, 128), (512, 100, 128),
                                   (512, 512, 48), (0, 128, 32),
                                   (128, 128, 0)])
def test_gemm_config_refuses_shapes_outside_the_gate(shape):
    with pytest.raises(ValueError):
        gemm_config(*shape)
