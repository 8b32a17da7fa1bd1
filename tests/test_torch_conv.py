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
