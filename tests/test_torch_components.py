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
from hypothesis import given, settings
from hypothesis import strategies as st

from inklayer_tpu.ops import components as J
from inklayer_tpu_torch.ops import components as T
from torch_masks import MASK_KINDS, adversarial_mask, straddle_stack


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


# ---------------------------------------------------------------------------
# The tile decomposition of the K6 / K6b kernels (csrc/components.cu),
# modelled in numpy: which 2 x 2 block makes which union, in which step
# ---------------------------------------------------------------------------

class _Forest:
    """Union-find over linear indices; a union links the larger root under
    the smaller, as the kernels' atomicMin does."""

    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, a):
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        self.parent[max(ra, rb)] = min(ra, rb)


def _block_bits(mask, y, x):
    """The 2 x 2 block at top left (y, x) as bits: 1 top left, 2 top
    right, 4 bottom left, 8 bottom right."""
    h, w = mask.shape
    return sum(bit for bit, (dy, dx) in ((1, (0, 0)), (2, (0, 1)),
                                         (4, (1, 0)), (8, (1, 1)))
               if y + dy < h and x + dx < w and mask[y + dy, x + dx])


def _first_pixel(bits, y, x, w):
    """The block's node: the linear index of its first set pixel."""
    if bits & 3:
        return y * w + x + (0 if bits & 1 else 1)
    return (y + 1) * w + x + (0 if bits & 4 else 1)


# which bits of a block and of its neighbour block touch (8-connectivity),
# by the neighbour's offset in pixels
_JOINS = {(0, -2): (5, 10), (-2, 0): (3, 12), (-2, -2): (1, 8),
          (-2, 2): (2, 4), (2, -2): (4, 2)}


def _tile_model(mask, th, tw):
    """Steps 1-3 of the kernels on one (H, W) mask with th x tw tiles of
    2 x 2 blocks: runs and unions of touching runs inside each tile, then
    the unions that blocks on a tile's top row or left column make with
    blocks in other tiles, then compression.  Returns (labels after step 1 as
    global indices of the local roots, final labels)."""
    h, w = mask.shape
    forest = _Forest(h * w)
    bits = {(y, x): _block_bits(mask, y, x)
            for y in range(0, h, 2) for x in range(0, w, 2)}

    def link(y, x, dy, dx):
        ny, nx = y + dy, x + dx
        if not (0 <= ny < h and 0 <= nx < w):
            return
        mine, theirs = _JOINS[(dy, dx)]
        if bits[(y, x)] & mine and bits[(ny, nx)] & theirs:
            forest.union(_first_pixel(bits[(y, x)], y, x, w),
                         _first_pixel(bits[(ny, nx)], ny, nx, w))

    def joins(y, x, dy, dx):
        ny, nx = y + dy, x + dx
        if not (0 <= ny < h and 0 <= nx < w) or (ny // th, nx // tw) != (
                y // th, x // tw):
            return False  # outside the mask or the tile
        mine, theirs = _JOINS[(dy, dx)]
        return bool(bits[(y, x)] & mine and bits[(ny, nx)] & theirs)

    def node(y, x):
        return _first_pixel(bits[(y, x)], y, x, w)

    # step 1, as label_tile: runs of blocks joined to their west neighbour
    # point at the run's smallest node; then each block unites its run with
    # each run above it touches, unless its west neighbour in the run
    # touches that run too
    run = {}
    for (y, x), b in bits.items():
        if b:
            run[(y, x)] = (run[(y, x - 2)] if joins(y, x, 0, -2)
                           else [])
            run[(y, x)].append(node(y, x))
    run = {k: min(v) for k, v in run.items()}
    for (y, x), r in run.items():
        if r != node(y, x):
            forest.parent[node(y, x)] = r

    def runs_above(y, x):
        return {run[(y - 2, x + dx)] for dx in (0, -2, 2)
                if joins(y, x, -2, dx)}

    for (y, x) in run:
        west = runs_above(y, x - 2) if joins(y, x, 0, -2) else set()
        for r in runs_above(y, x) - west:
            forest.union(node(y, x), r)

    def labels():
        out = np.full((h, w), -1)
        for y, x in zip(*np.nonzero(mask)):
            by, bx = y - y % 2, x - x % 2
            out[y, x] = forest.find(_first_pixel(bits[(by, bx)], by, bx, w))
        return out

    local = labels()
    for (y, x), b in bits.items():  # step 2, as cc_border
        top, left = y % th == 0 and y > 0, x % tw == 0 and x > 0
        if not b or not (top or left):
            continue
        if left:
            link(y, x, 0, -2)
        if top:
            link(y, x, -2, 0)
            link(y, x, -2, 2)
        link(y, x, -2, -2)
        if left and (y % th) // 2 + 1 < th // 2:
            link(y, x, 2, -2)
    return local, labels()


def _check_tile_model(mask, th, tw):
    """The model against the plain versions: each tile's local labels are
    that tile's own components, the final labels the mask's; every 2 x 2
    cell holds at most one root; the keep rule from per-cell statistics
    (ymin from the root's row) is clean_components'."""
    h, w = mask.shape
    local, final = _tile_model(mask, th, tw)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            sub = mask[y0:y0 + th, x0:x0 + tw]
            lab = T.connected_components_plain(
                torch.from_numpy(np.ascontiguousarray(sub))[None])[0].numpy()
            sw = sub.shape[1]
            want = np.where(lab >= 0, (y0 + lab // sw) * w + x0 + lab % sw,
                            -1)
            np.testing.assert_array_equal(local[y0:y0 + th, x0:x0 + tw],
                                          want)
    plain = T.connected_components_plain(torch.from_numpy(mask)[None])[0]
    np.testing.assert_array_equal(final, plain.numpy())
    roots = np.unique(final[final >= 0])
    cells = {(r // w // 2, r % w // 2) for r in roots}
    assert len(cells) == len(roots)
    keep = np.zeros((h, w), bool)
    for r in roots:
        ys, xs = np.nonzero(final == r)
        assert ys.min() == r // w
        ww, hh = np.float32(np.ptp(xs) + 1), np.float32(ys.max() - r // w + 1)
        aspect = np.float32(max(ww, hh)) / (np.float32(min(ww, hh))
                                            + np.float32(1e-5))
        keep[final == r] = len(ys) > 6 or aspect > np.float32(1.5)
    want, _ = T.clean_components_plain(torch.from_numpy(mask)[None], 6, 1.5)
    np.testing.assert_array_equal(keep, want[0].numpy())


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_tile_model_on_adversarial_masks(kind, tile):
    for h, w in ((37, 45), (16, 16), (1, 19), (19, 1), (1, 1), (9, 2)):
        mask = adversarial_mask(kind, h, w, grid=tile).numpy()
        _check_tile_model(mask, tile, tile)


@pytest.mark.parametrize("tile", [(4, 4), (8, 8), (4, 8)])
@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=st.data())
def test_tile_model_on_drawn_masks(tile, data):
    h = data.draw(st.integers(1, 26), label="h")
    w = data.draw(st.integers(1, 26), label="w")
    density = data.draw(st.sampled_from([0.2, 0.45, 0.6, 0.9]))
    seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
    mask = np.random.default_rng(seed).random((h, w)) < density
    _check_tile_model(mask, *tile)


def _keep_pass_model(labels, min_area, min_aspect):
    """The keep pass (cc_keep) on a (N, H, W) label stack, flattened: four
    pixels per thread, one root's decision cached along them and dropped
    where a mask starts (roots are indices within one mask)."""
    n, h, w = labels.shape
    decide = {}
    for m in range(n):
        for r in np.unique(labels[m][labels[m] >= 0]):
            ys, xs = np.nonzero(labels[m] == r)
            ww = np.float32(np.ptp(xs) + 1)
            hh = np.float32(ys.max() - r // w + 1)
            aspect = np.float32(max(ww, hh)) / (np.float32(min(ww, hh))
                                                + np.float32(1e-5))
            decide[(m, r)] = len(ys) > min_area or aspect > np.float32(
                min_aspect)
    flat = labels.reshape(-1)
    out = np.zeros(flat.size, bool)
    for base in range(0, flat.size, 4):
        m, at = divmod(base, h * w)
        last, keep = -1, False
        for p in range(base, min(base + 4, flat.size)):
            if at == h * w:
                m, at, last = m + 1, 0, -1
            if flat[p] >= 0:
                if flat[p] != last:
                    last, keep = flat[p], decide[(m, flat[p])]
                out[p] = keep
            at += 1
    return out.reshape(n, h, w)


@pytest.mark.parametrize("h,w", [(1, 3), (3, 3), (1, 6), (7, 11), (4, 5),
                                 (5, 8)])
def test_keep_pass_model_where_groups_straddle_masks(h, w):
    """H * W % 4 in {0, 1, 2, 3}: full masks beside lone pixels at (0, 0)
    (both root 0 of their mask) and random masks, held to
    clean_components_plain."""
    rng = np.random.default_rng(h * 100 + w)
    masks = torch.cat([straddle_stack(4, h, w),
                       torch.from_numpy(rng.random((3, h, w)) < 0.5)])
    labels = T.connected_components_plain(masks).numpy()
    want, _ = T.clean_components_plain(masks, 2, 2.0)
    np.testing.assert_array_equal(_keep_pass_model(labels, 2, 2.0),
                                  want.numpy())
