"""``depth_graph_share.<cell>``: the share of the depth calls in the traced
sub-window whose forward replayed a CUDA graph captured by an earlier call:
the sum of ``graphed`` over the number of the program's ``depth`` spans
(``DepthEstimator.infer_image_device``).  No reading where no ``depth``
span counts ``graphed`` (a program that captures no graph)."""

from gpubench.metrics._program_spans import records


def read(ctx, metric):
    if ctx.trace is None:
        return None
    depth = [s for s in records(ctx) if s.name == "depth"]
    if not any("graphed" in s.counts for s in depth):
        return None
    return sum(s.counts.get("graphed", 0) for s in depth) / len(depth)
