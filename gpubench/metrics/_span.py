"""Device time per sketch of the kernels the host launched inside one of
the entry's spans (``gpubench/<span>``), in the traced sub-window."""


def device_ms_per_unit(ctx, span: str):
    t = ctx.trace
    if t is None or not ctx.trace_units:
        return None
    us = t.span_us(span)
    return us / 1e3 / ctx.trace_units if us > 0 else None
