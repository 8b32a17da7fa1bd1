"""Bool masks built to break a tile-based connected-components labelling,
shared by the CPU test of the tile decomposition
(``test_torch_components.py``) and the card tests of the kernels
(``test_torch_kernels_gpu.py``).  Plain torch on the CPU; no jax."""

import torch


def _spiral(h, w):
    """A 1 px rectangular spiral, arms one pixel apart: one component that
    crosses every tile border many times."""
    m = [[False] * w for _ in range(h)]
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    y = x = d = 0
    m[0][0] = True

    def free(a, b):
        return 0 <= a < h and 0 <= b < w and not m[a][b]

    while True:
        for _ in range(2):  # straight on, else turn once
            dy, dx = dirs[d]
            ny, nx = y + dy, x + dx
            if free(ny, nx) and free(ny + dy, nx + dx) or (
                    free(ny, nx) and not (0 <= ny + dy < h
                                          and 0 <= nx + dx < w)):
                y, x = ny, nx
                m[y][x] = True
                break
            d = (d + 1) % 4
        else:
            return torch.tensor(m)


def adversarial_mask(kind, h, w, grid=16):
    """(h, w) bool masks built to break a tile-based labelling; "corners"
    marks the corners of every ``grid`` x ``grid`` cell."""
    y = torch.arange(h)[:, None]
    x = torch.arange(w)[None, :]
    if kind == "serpentine":  # rows 0, 2, 4 ... joined at alternate ends
        m = (y % 2 == 0).expand(h, w).clone()
        for r in range(1, h, 2):
            m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
        return m
    if kind == "spiral":
        return _spiral(h, w)
    if kind == "comb":  # a spine and teeth one pixel apart
        m = (x % 2 == 0).expand(h, w).clone()
        m[0] = True
        m[-1, 1::4] = True  # and short stubs off the bottom
        return m
    if kind == "full":  # one root, every pixel contends for it
        return torch.ones(h, w, dtype=torch.bool)
    if kind == "checkerboard":  # joined only through diagonals
        return ((y + x) % 2 == 0).expand(h, w).clone()
    if kind == "corners":  # diagonal and anti-diagonal pairs across every
        m = torch.zeros(h, w, dtype=torch.bool)  # grid corner, and single
        for cy in range(grid, h, grid):          # pixels beside them
            for cx in range(grid, w, grid):
                if (cy // grid + cx // grid) % 2:
                    m[cy - 1, cx - 1] = m[cy, cx] = True
                else:
                    m[cy - 1, cx] = m[cy, cx - 1] = True
                if cx + 3 < w and grid > 6:
                    m[cy, cx + 3] = True
        m[0, 0] = m[h - 1, w - 1] = True
        return m
    if kind == "blobs":
        g = torch.Generator().manual_seed(h * 1000 + w)
        noise = torch.rand(1, 1, max(h // 8, 1), max(w // 8, 1), generator=g)
        m = torch.nn.functional.interpolate(noise, size=(h, w),
                                            mode="bilinear")[0, 0] > 0.6
        return m | (torch.rand(h, w, generator=g) > 0.99)
    raise ValueError(kind)


def straddle_stack(n, h, w):
    """(n, h, w) bool: full masks alternating with masks that hold one
    pixel, at (0, 0).  Where H * W % 4 != 0, four consecutive pixels of the
    stack can hold a full mask's last pixel and the next mask's first: both
    have root 0 in their own mask, and a keep rule with min_area < H * W
    keeps the one and drops the other."""
    m = torch.zeros(n, h, w, dtype=torch.bool)
    m[0::2] = True
    m[1::2, 0, 0] = True
    return m


MASK_KINDS = ("serpentine", "spiral", "comb", "full", "checkerboard",
              "corners", "blobs")
