"""DPT head, Depth-Anything-V2 and the depth estimator (port of
:mod:`inklayer_tpu.models.depth.dpt`).

Parameter names follow the reference checkpoint (``depth_head.projects``,
``resize_layers``, ``scratch.refinenet{i}``...), so the JAX package's
``DEPTH_RULES`` bridge them.  The head runs NCHW (PyTorch's conv layout);
its bilinear upsamples use the align_corners=True weight matrices of
:func:`inklayer_tpu_torch.ops.image.resize_align_corners`.  The JAX
package's stride-k transposed convs ('SAME' padding, k == stride) do not
overlap, so they are ``nn.ConvTranspose2d`` with the bridge's flipped
weights.  The estimator's preprocessing (normalise, bicubic antialiased
resize to the bucket) and the align_corners resize back follow
``DepthEstimator._infer_full``.

On the card the estimator replays the model's forward from a CUDA graph,
one per input shape (:class:`DepthEstimator`): the forward reads nothing
back to the host and its shapes are fixed by the bucket, so one graph
launch replaces its ~400 eager launches.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as _module

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.config import DepthConfig
from inklayer_tpu_torch.models.depth.dinov2 import DinoVisionTransformer
from inklayer_tpu_torch.ops.image import (device_vector, holding, resize,
                                          resize_align_corners)
from inklayer_tpu_torch.runtime import use_kernel
from inklayer_tpu_torch.spans import span

# [0,1]-scale ImageNet stats (util/transform.py NormalizeImage)
DEPTH_MEAN = (0.485, 0.456, 0.406)
DEPTH_STD = (0.229, 0.224, 0.225)
# captured forwards a DepthEstimator keeps (LRU); the bucket grid of
# depth_bucket has 25 shapes
GRAPHS = 8


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """``with_skip=False`` for refinenet4, which the JAX package calls
    without a skip input (and so has no resConfUnit1 params)."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(resize_align_corners(x, tuple(out_hw)))


class _Scratch(nn.Module):
    def __init__(self, cfg: DepthConfig):
        super().__init__()
        f = cfg.features
        for i, oc in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, i != 4))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: DepthConfig = DepthConfig()):
        super().__init__()
        self.cfg = cfg
        oc = cfg.out_channels
        self.projects = nn.ModuleList(
            nn.Conv2d(cfg.embed_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(cfg)

    def forward(self, taps, patch_hw: Tuple[int, int]) -> torch.Tensor:
        """taps: 4 x ((B, N, C) tokens, cls) -> (B, 14 ph, 14 pw) relative
        depth (ReLU'd; sigmoid for the metric variant)."""
        ph, pw = patch_hw
        sc = self.scratch
        feats = []
        for i, (tok, _cls) in enumerate(taps):
            x = tok.reshape(tok.shape[0], ph, pw, -1).permute(0, 3, 1, 2)
            x = self.resize_layers[i](self.projects[i](x))
            feats.append(getattr(sc, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = feats
        p4 = sc.refinenet4(l4, out_hw=l3.shape[2:])
        p3 = sc.refinenet3(p4, l3, out_hw=l2.shape[2:])
        p2 = sc.refinenet2(p3, l2, out_hw=l1.shape[2:])
        p1 = sc.refinenet1(p2, l1)
        x = sc.output_conv1(p1)
        x = resize_align_corners(x, (ph * self.cfg.patch_size,
                                     pw * self.cfg.patch_size))
        x = sc.output_conv2(x)[:, 0]
        return torch.sigmoid(x) if self.cfg.max_depth > 0 else F.relu(x)


class DepthAnythingV2(nn.Module):
    def __init__(self, cfg: DepthConfig = DepthConfig()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg)
        self.depth_head = DPTHead(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.pretrained.pos_embed.dtype

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised, H and W multiples of the patch ->
        (B, H, W) fp32 relative depth."""
        c = self.cfg
        ph, pw = image.shape[1] // c.patch_size, image.shape[2] // c.patch_size
        taps = self.pretrained(image.to(self.dtype), c.intermediate_layers)
        out = self.depth_head(taps, (ph, pw)).float()
        return out * c.max_depth if c.max_depth > 0 else out


def depth_bucket(h: int, w: int, cfg: DepthConfig) -> Tuple[int, int]:
    """The reference Resize (lower bound input_size, keep aspect, multiple
    of 14), snapped to the JAX package's bounded bucket grid."""
    scale = cfg.input_size / min(h, w)
    nh = int(round(h * scale / cfg.patch_size)) * cfg.patch_size
    nw = int(round(w * scale / cfg.patch_size)) * cfg.patch_size
    cap = 2 * cfg.input_size
    nh = max(min(nh, cap), cfg.input_size)
    nw = max(min(nw, cap), cfg.input_size)
    snap = 140  # 10 patches
    nh = cfg.input_size + ((nh - cfg.input_size + snap - 1) // snap) * snap
    nw = cfg.input_size + ((nw - cfg.input_size + snap - 1) // snap) * snap
    return min(nh, cap + snap), min(nw, cap + snap)


def quantize_depth(depth: torch.Tensor) -> torch.Tensor:
    """(H, W) float depth -> uint8 0-255 min-max normalised (refiner.py
    depth_map.png), truncated as the JAX package's astype(uint8)."""
    lo, hi = depth.min(), depth.max()
    rng = hi - lo
    norm = (depth - lo) / torch.clamp(rng, min=1e-12) * 255.0
    return torch.where(rng > 0, norm, 0.0).to(torch.uint8)


class _Graph:
    """One captured forward: the graph, its static input and output, the
    kernel launches one replay makes, and the device constants it reads
    (kept alive here whatever the constants' cache drops)."""

    __slots__ = ("graph", "x", "out", "launches", "constants")


class DepthEstimator:
    """DepthAnythingV2.infer_image (dpt.py:187-221) over a built model.

    Where the model's kernels run on the card and :meth:`replayable` holds,
    its forward is replayed from a CUDA graph, one per key (the bucket
    shape, batch, dtype and device): the first call of a key runs eagerly
    (it warms cuBLAS and cuDNN and notes the constants the forward reads),
    the second captures the graph on a side stream and replays it, later
    calls copy the pre-processed image into the graph's static input and
    replay.  Graphs share one memory pool; the last :data:`GRAPHS` keys
    used are kept.  The CPU path and the tp-sharded forward stay eager.

    Callers may run on several threads and streams: a lock holds the
    copy-in, replay and the resize that reads the static output together,
    and each replay's stream first waits for an event recorded after the
    previous resize, so no replay writes a buffer another caller's
    queued work still reads.  The returned map is a new tensor."""

    def __init__(self, model: DepthAnythingV2):
        self.model = model
        self.cfg = model.cfg
        mods = tuple(model.modules())
        # what replayable() reads: the modules a tp plan shards, every hook
        # dict (registering a hook adds to its dict)
        self._tp_modules = tuple(m for m in mods if "tp" in vars(m))
        self._hook_dicts = tuple(
            d for m in mods for d in (m._forward_hooks, m._forward_pre_hooks)
        ) + (_module._global_forward_hooks, _module._global_forward_pre_hooks)
        # key -> the constants its eager call read (seen once) or its _Graph
        self._graphs: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()
        self._pool = None
        self._done = None  # recorded after each replay's resize

    def replayable(self) -> bool:
        """True when a replayed graph of the model's forward does what the
        forward does: no module is tp-sharded (the tp forward runs
        collectives) and no forward hook or pre-hook is registered, on a
        module or globally (a replay calls none)."""
        return not (any(self._hook_dicts)
                    or any(m.tp is not None for m in self._tp_modules))

    @torch.inference_mode()
    def infer_image_device(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 RGB on the model's device -> (H, W) fp32
        relative depth on that device.  The ``depth`` span counts
        ``graphed``: 1 where the forward was a replay of a graph captured
        by an earlier call, else 0."""
        h, w = image.shape[:2]
        bh, bw = depth_bucket(h, w, self.cfg)
        dev = image.device
        with span("depth") as sp:
            with span("depth.preprocess"):
                x = image.float() / 255.0
                x = (x - device_vector(DEPTH_MEAN, dev)) \
                    / device_vector(DEPTH_STD, dev)
                x = resize(x, (bh, bw), "bicubic", antialias=True)[None]
            if not (use_kernel(x) and self.replayable()):
                sp.count(graphed=0)
                with span("depth.forward"):
                    depth = self.model(x)[0]
                with span("depth.resize"):
                    return resize_align_corners(depth, (h, w))
            with self._lock:
                key = (tuple(x.shape), self.model.dtype, dev)
                entry = self._graphs.get(key)
                sp.count(graphed=int(isinstance(entry, _Graph)))
                with span("depth.forward"):
                    if entry is None:
                        held = {}
                        with holding(held):
                            out = self.model(x)
                        self._keep(key, held)
                    else:
                        self._graphs.move_to_end(key)
                        if not isinstance(entry, _Graph):
                            entry = self._capture(key, x, entry)
                        out = self._replay(entry, x)
                with span("depth.resize"):
                    depth = resize_align_corners(out[0], (h, w))
                if entry is not None:
                    self._done.record(torch.cuda.current_stream(dev))
                return depth

    def _keep(self, key: tuple, entry) -> None:
        self._graphs[key] = entry
        while len(self._graphs) > GRAPHS:
            _, old = self._graphs.popitem(last=False)
            if isinstance(old, _Graph):
                self._done.synchronize()  # its buffers' last reader ran

    def _capture(self, key: tuple, x: torch.Tensor,
                 held: Dict[tuple, torch.Tensor]) -> _Graph:
        """PyTorch's capture recipe: a side stream that waits for the
        caller's, static input and output, this thread's launches counted
        into the graph (nothing runs until a replay)."""
        dev = x.device
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._done = torch.cuda.Event()
            g = _Graph()
            g.x, g.constants = torch.empty_like(x), held
            g.graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with holding(held), _kernels.captured_launches() as launches, \
                    torch.cuda.graph(g.graph, pool=self._pool, stream=side,
                                     capture_error_mode="thread_local"):
                g.out = self.model(g.x)
            torch.cuda.current_stream(dev).wait_stream(side)
        g.launches = launches
        self._keep(key, g)
        return g

    def _replay(self, g: _Graph, x: torch.Tensor) -> torch.Tensor:
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(self._done)
        g.x.copy_(x)
        g.graph.replay()
        _kernels.add_launches(g.launches)
        return g.out

    def infer_image(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB numpy -> (H, W) float32 relative depth
        numpy: uploaded to the model's device and read back."""
        dev = self.model.pretrained.pos_embed.device
        depth = self.infer_image_device(
            torch.from_numpy(np.array(image)).to(dev))
        return depth.float().cpu().numpy()
