"""Depth-Anything-V2's forward on the card, eager against replayed from
its CUDA graph (``DepthEstimator``).

    python3 scripts/torch_depth_graph.py [--encoder vitb] [--calls 20]
        [--hw 750x750 750x1100]

For each sketch size it builds an estimator at the encoder's published
widths (bf16; weights N(0, 0.02), biases 0, norm scales and LayerScale 1)
and prints one JSON line:

* ``eager_host_ms`` / ``eager_wall_ms``: the median over ``--calls`` calls
  of the host time until the call returns (its launches queued) and until
  the card has finished it too; the forward is held eager by a no-op
  forward hook;
* ``capture_s``: the wall time of the call that captures the graph;
* ``pool_bytes``: the device memory the capture left allocated (the
  graph's pool and its static input);
* ``replay_host_ms`` / ``replay_wall_ms``: as the eager pair, for calls
  that replay the graph;
* ``equal``: every replayed map equals the eager map bit for bit.

Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gpubench.run import card_info  # noqa: E402
from inklayer_tpu_torch.config import DepthConfig  # noqa: E402
from inklayer_tpu_torch.models.depth import (DepthAnythingV2,  # noqa: E402
                                             DepthEstimator)

PRESETS = {"vits": DepthConfig.vits, "vitb": DepthConfig,
           "vitl": DepthConfig.vitl}


def seeded_model(cfg: DepthConfig, seed: int = 0) -> DepthAnythingV2:
    g = torch.Generator(device="cuda").manual_seed(seed)
    model = DepthAnythingV2(cfg).to("cuda").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
            else:
                p.fill_(0.0 if name.endswith("bias") else 1.0)
    return model.to(torch.bfloat16)


def timed_calls(est, image, calls: int):
    """(median host ms to return, median wall ms to finish, the maps)."""
    host, wall, maps = [], [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps.append(est.infer_image_device(image))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall), maps


def measure(model, hw, calls: int) -> dict:
    est = DepthEstimator(model)
    g = torch.Generator(device="cuda").manual_seed(hw[0] * 10_000 + hw[1])
    image = torch.randint(0, 256, (*hw, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    hook = model.register_forward_hook(lambda *a: None)
    try:
        est.infer_image_device(image)  # warm
        eager_host, eager_wall, eager = timed_calls(est, image, calls)
    finally:
        hook.remove()
    est.infer_image_device(image)  # the first call of the key: eager
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    est.infer_image_device(image)  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool = torch.cuda.memory_allocated() - before
    replay_host, replay_wall, replayed = timed_calls(est, image, calls)
    return {"hw": list(hw), "eager_host_ms": eager_host,
            "eager_wall_ms": eager_wall, "capture_s": capture_s,
            "pool_bytes": pool, "replay_host_ms": replay_host,
            "replay_wall_ms": replay_wall,
            "equal": all(torch.equal(m, eager[0]) for m in eager + replayed)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", choices=sorted(PRESETS), default="vitb")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--hw", nargs="+", default=["750x750", "750x1100"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    model = seeded_model(PRESETS[args.encoder]())
    card = card_info()
    for text in args.hw:
        hw = tuple(int(v) for v in text.split("x"))
        print(json.dumps({"encoder": args.encoder, **card,
                          **measure(model, hw, args.calls)}), flush=True)


if __name__ == "__main__":
    main()
