"""Port parity: the SAM MLP fc1 -> exact GELU -> fc2
(inklayer_tpu_torch.ops.mlp.mlp_gelu and nn.layers.MLP) against the JAX
package's Pallas mlp_gelu in interpret mode (bf16) and its XLA MLP (fp32).

Tolerances: bf16 kernel path rtol 2e-2; fp32 XLA path atol = rtol = 1e-4;
the TPU kernel's polynomial erf against torch's exact erf GELU 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inklayer_tpu.nn.layers import MLP as JaxMLP
from inklayer_tpu.ops.mlp import _gelu, mlp_gelu
from inklayer_tpu_torch.nn.layers import MLP
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
