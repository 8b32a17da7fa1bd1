"""Port parity: the mask read-backs of ``inklayer_tpu_torch.ops.bits``
against the JAX package's ``inklayer_tpu.ops.bits`` on seeded masks, all
exact: packing, unpacking, label maps and the batched final read-back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.ops import bits as J
from inklayer_tpu_torch.ops import bits as T

SHAPES = [(3, 17, 23), (2, 16, 16), (1, 5, 8), (4, 1, 9)]


def _masks(shape, seed=0, p=0.5):
    return np.random.default_rng(seed).random(shape) < p


def _disjoint(n, h, w, seed=0):
    """n disjoint masks: each pixel in at most one, some in none."""
    lab = np.random.default_rng(seed).integers(0, n + 1, (h, w))
    return lab[None] == np.arange(1, n + 1)[:, None, None]


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_bits_matches_jax_and_packbits(shape):
    m = _masks(shape)
    got = T.pack_bits(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.pack_bits(jnp.asarray(m))))
    np.testing.assert_array_equal(got, np.packbits(m, axis=-1))


@pytest.mark.parametrize("shape", SHAPES)
def test_unpack_and_masks_to_host_round_trip(shape):
    m = _masks(shape, seed=1)
    packed = np.packbits(m, axis=-1)
    np.testing.assert_array_equal(T.unpack_bits_host(packed, shape[-1]),
                                  J.unpack_bits_host(packed, shape[-1]))
    np.testing.assert_array_equal(T.masks_to_host(torch.from_numpy(m)), m)
    np.testing.assert_array_equal(T.masks_to_host(torch.from_numpy(m)),
                                  J.masks_to_host(jnp.asarray(m)))
    empty = T.masks_to_host(torch.zeros((0,) + shape[1:], dtype=torch.bool))
    assert empty.shape == (0,) + shape[1:] and empty.dtype == bool


@pytest.mark.parametrize("n", [1, 5, 12])
def test_label_map_matches_jax(n):
    for masks in (_disjoint(n, 19, 21, seed=n), _masks((n, 19, 21), seed=n)):
        lab, ok = T._label_map_u8(torch.from_numpy(masks))
        jlab, jok = J._label_map_u8(jnp.asarray(masks))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
        assert bool(ok) == bool(jok)
        assert lab.dtype == torch.uint8


@pytest.mark.parametrize("kind", ["disjoint", "overlapping"])
def test_disjoint_masks_to_host_matches_jax(kind):
    masks = (_disjoint(6, 13, 30, seed=3) if kind == "disjoint"
             else _masks((6, 13, 30), seed=3))
    got = T.disjoint_masks_to_host(torch.from_numpy(masks))
    np.testing.assert_array_equal(
        got, J.disjoint_masks_to_host(jnp.asarray(masks)))
    np.testing.assert_array_equal(got, masks)


def test_batched_final_readback_matches_jax():
    """A disjoint stack, an overlapping one, an empty one and one of more
    than 255 masks (packed), with extras of several types, in one
    read-back."""
    stacks = [_disjoint(7, 20, 24, seed=4), _masks((3, 20, 24), seed=5),
              np.zeros((0, 20, 24), bool), _masks((256, 2, 9), seed=6)]
    extras = [np.random.default_rng(7).integers(0, 255, (20, 24))
              .astype(np.uint8), np.asarray(True), np.asarray([1.5, -2.0],
                                                            np.float32)]
    got = T.batched_final_readback([torch.from_numpy(s) for s in stacks],
                                   [torch.from_numpy(e) for e in extras],
                                   with_labels=True)
    want = J.batched_final_readback([jnp.asarray(s) for s in stacks],
                                    [jnp.asarray(e) for e in extras],
                                    with_labels=True)
    for g, w, s in zip(got[0], want[0], stacks):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got[2], want[2]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    assert [g is None for g in got[2]] == [False, True, True, True]
    out, extra = T.batched_final_readback([torch.from_numpy(stacks[0])])
    np.testing.assert_array_equal(out[0], stacks[0])
    assert extra == []


def test_readback_returns_each_tensor_in_order():
    """The CPU read-back hands back each tensor's values, a transposed
    view as its own layout."""
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    wait = T.readback([t, t.T])
    a, b = wait()
    np.testing.assert_array_equal(a, np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(b, np.arange(6).reshape(2, 3).T)


@pytest.mark.parametrize("shape", SHAPES + [(0, 16, 16), (2, 0, 5),
                                            (3, 21, 37)])
def test_masks_to_device_matches_jax(shape):
    """The packed upload, widths that are and are not a multiple of 8 and
    empty stacks: exactly the host masks and the JAX package's."""
    m = _masks(shape, seed=4)
    got = T.masks_to_device(m, "cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), m)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(J.masks_to_device(m)))
    if m.size:  # the device unpack inverts pack_bits
        np.testing.assert_array_equal(T.unpack_bits(
            T.pack_bits(torch.from_numpy(m)), shape[-1]).numpy(), m)
