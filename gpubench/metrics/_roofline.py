"""A kernel's share of its roofline over the traced sub-window: the sum
over its launches of the least time the card could take for each (the
larger of operations over the bf16 peak and bytes over the memory
bandwidth, ``gpubench/flops/<kernel>.py`` at the configuration's shapes),
over the traced device time of the kernel's events, in percent.

Nothing is read where the traced launches are not the ones the
configuration's shapes predict (the kernel left the path, or its launches
changed): a later program without the kernel leaves the metric silent.
"""

from gpubench.peaks import bound_s


def share(ctx, kernel: str, counter: str, pattern: str, per_launch: int):
    t = ctx.trace
    if t is None or not ctx.trace_requests:
        return None
    cfg = ctx.manifest.flops(ctx.cell.config_entry["name"])
    shapes = cfg.kernel_launches(ctx.cell.config, ctx.cell.traffic)[kernel]
    shapes = shapes * ctx.trace_requests
    if t.launched.get(counter, 0) != len(shapes):
        return None
    us, n = t.kernel_us(pattern)
    if n != len(shapes) * per_launch or us <= 0:
        return None
    arith = ctx.manifest.flops(kernel)
    kind = ctx.card.get("kind", "")
    bound = sum(bound_s(arith.ops(s), arith.bytes_moved(s), kind)
                for s in shapes)
    return 100.0 * bound / (us / 1e6)
