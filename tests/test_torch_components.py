"""Port parity: connected components and the mask-cleaning component keep
(the plain versions of the K6b / K6 kernels) against the JAX package's XLA
path on the CPU (``connected_components``, ``clean_components_batch``).

The port is exact (no iteration or component cap); the JAX XLA path stops
after 64 propagation steps and examines at most 128 components.  Labels
and cleaned masks must be equal exactly on every mask the JAX package
reports as uncapped with <= 128 components; the shapes below are chosen so
that all of them are, and the test asserts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.ops import components as J
from inklayer_tpu_torch.ops import components as T


def _spiral(n: int) -> np.ndarray:
    """A 1 px square spiral in an n x n mask, arms one pixel apart: one
    component whose propagation path winds through the whole mask."""
    m = np.zeros((n, n), bool)
    dirs = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    y = x = d = 0
    m[0, 0] = True
    inside = lambda a, b: 0 <= a < n and 0 <= b < n
    while True:
        for _ in range(2):  # straight on, else turn once
            dy, dx = dirs[d]
            ny, nx = y + dy, x + dx
            if inside(ny, nx) and not m[ny, nx] and not (
                    inside(ny + dy, nx + dx) and m[ny + dy, nx + dx]):
                y, x = ny, nx
                m[y, x] = True
                break
            d = (d + 1) % 4
        else:
            return m


def _stack(rng, h: int = 48, w: int = 56) -> np.ndarray:
    masks = np.zeros((7, h, w), bool)
    masks[0, 5:40, 5:12] = True            # U-shape: two arms ...
    masks[0, 5:40, 30:37] = True
    masks[0, 34:40, 5:37] = True           # ... joined at the bottom
    masks[1, :36, :36] = _spiral(36)        # spiral: many steps
    masks[2] = rng.random((h, w)) < 0.04    # speckle: many components
    masks[3, 10, 3:50] = True               # thin lines: the aspect rule
    masks[3, 20:45, 40] = True
    masks[3, 30:33, 10:13] = True           # small square: dropped
    masks[4, 2:30, 2:30] = True             # big blob + diagonal chain
    for i in range(15):
        masks[4, 31 + i, 31 + i] = True
    masks[5, 0, :] = True                   # touches every border
    masks[5, :, 0] = True
    masks[5, -1, :] = True
    masks[5, :, -1] = True
    return masks                            # masks[6]: empty


def _jax_labels(masks):
    labels, capped, _ = [np.asarray(a) for a in zip(*[
        J.connected_components(jnp.asarray(m), with_stats=True)
        for m in masks])]
    return np.stack(labels), np.stack(capped)


@pytest.fixture(scope="module")
def stack():
    return _stack(np.random.default_rng(0))


def test_labels_match_jax_exactly(stack):
    want, capped = _jax_labels(stack)
    assert not capped.any()
    assert 20 < len(np.unique(want[2])) - 1 <= 128
    got = T.connected_components(torch.from_numpy(stack))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the label is the component's smallest linear index
    assert got[1].max() == 0 and (got[6] == -1).all()


@pytest.mark.parametrize("min_area,min_aspect", [(20, 1.1), (100, 3.0),
                                                 (5, 100.0)])
def test_clean_components_matches_jax_exactly(stack, min_area, min_aspect):
    want, capped = J.clean_components_batch(
        jnp.asarray(stack), min_area, min_aspect, with_stats=True)
    assert not np.asarray(capped).any()
    got, got_capped = T.clean_components(torch.from_numpy(stack), min_area,
                                         min_aspect)
    assert got.dtype == torch.bool and not got_capped.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_both_keep_rules_fire(stack):
    """The stack exercises area-only keeps, aspect-only keeps and drops."""
    got, _ = T.clean_components(torch.from_numpy(stack), 20, 1.1)
    got = got.numpy()
    assert got[3, 10, 3:50].all() and got[3, 20:45, 40].all()  # thin: aspect
    assert not got[3, 30:33, 10:13].any()  # small square: dropped
    assert got[0].sum() == stack[0].sum()  # big U: area


def test_large_component_mask_and_stats_match_jax(stack):
    for m in stack[:6]:
        want = np.asarray(J.large_component_mask(jnp.asarray(m), 30))
        got = T.large_component_mask(torch.from_numpy(m), 30).numpy()
        np.testing.assert_array_equal(got, want)
    lab = J.connected_components(jnp.asarray(stack[2]))
    for g, w in zip(T.component_stats(torch.from_numpy(np.array(lab))),
                    J.component_stats(lab)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_stack():
    masks = torch.zeros((0, 9, 11), dtype=torch.bool)
    assert T.connected_components(masks).shape == (0, 9, 11)
    cleaned, capped = T.clean_components(masks, 10, 1.1)
    assert cleaned.shape == (0, 9, 11) and capped.shape == (0,)
