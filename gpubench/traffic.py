"""The one traffic generator: seeded stroke sketches, grouped into requests.

A traffic mix (``gpubench/workloads/<cell>.json``) gives:

* ``sketch_hw``: the size of every sketch, (H, W);
* ``strokes``: [least, most] strokes a sketch, ``stroke_px``: [least,
  most] pixels a line is wide, ``stroke_points``: [least, most] points a
  polyline has;
* ``batch``: sketches a request;
* ``pool``: distinct sketches the window cycles through (request r takes
  sketches r * batch .. r * batch + batch - 1 of the pool, modulo its
  size); ``warmup``: requests sent in set-up, from sketches outside the
  pool;
* ``loop``: ``closed`` (one client sends its next request when the last
  one has come back) is the only kind;

Every sketch is drawn from ``numpy.random.default_rng([seed, i])``, so the
same seed gives the same sketches, and every seed gives sketches of the
same size and the same request sizes (only the strokes differ).
"""

from __future__ import annotations

from typing import List

import numpy as np
from PIL import Image, ImageDraw

LOOPS = ("closed",)


def sketch(seed: int, index: int, hw, strokes, stroke_px,
           stroke_points) -> np.ndarray:
    """One (H, W, 3) uint8 sketch: black polylines on white."""
    rng = np.random.default_rng([seed % (1 << 63), index])
    h, w = hw
    img = Image.new("RGB", (w, h), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(strokes[0], strokes[1] + 1))):
        n = int(rng.integers(stroke_points[0], stroke_points[1] + 1))
        start = rng.uniform((0, 0), (w, h))
        steps = rng.normal(0.0, 0.06 * min(h, w), (n - 1, 2))
        pts = np.clip(np.vstack([start, start + np.cumsum(steps, 0)]),
                      0, (w - 1, h - 1))
        width = int(rng.integers(stroke_px[0], stroke_px[1] + 1))
        draw.line([tuple(p) for p in pts.tolist()], fill=(0, 0, 0),
                  width=width, joint="curve")
    return np.array(img)


class Traffic:
    """The requests of one run, from a traffic mix and a seed."""

    def __init__(self, mix: dict, seed: int):
        if mix.get("loop") not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got "
                             f"{mix.get('loop')!r}")
        self.mix = mix
        self.seed = seed
        self.batch = int(mix["batch"])
        self.pool_size = int(mix["pool"])
        self._pool = [self._draw(i) for i in range(self.pool_size)]

    def _draw(self, index: int) -> np.ndarray:
        m = self.mix
        return sketch(self.seed, index, tuple(m["sketch_hw"]), m["strokes"],
                      m["stroke_px"], m["stroke_points"])

    def pool_index(self, request: int, j: int) -> int:
        return (request * self.batch + j) % self.pool_size

    def request(self, r: int) -> List[np.ndarray]:
        """Request ``r``'s sketches."""
        return [self._pool[self.pool_index(r, j)] for j in range(self.batch)]

    def warmup(self, r: int) -> List[np.ndarray]:
        """Set-up request ``r``: sketches drawn past the pool's end."""
        base = self.pool_size + r * self.batch
        return [self._draw(base + j) for j in range(self.batch)]
