"""``glue_idle_ms.<cell>``: card-idle ms per sketch while the host was
inside a traced request but outside the program's ``inpaint.loop`` spans:
the layers' assembly, the host pre- and post-processing, the VAE's encode
and decode around the loop, the composite; the clocks checked as
:mod:`gpubench.metrics._inpaint_idle` says."""

from gpubench.metrics._inpaint_idle import split


def read(ctx, metric):
    got = split(ctx)
    if got is None or not ctx.trace_units:
        return None
    return got[1] / 1e3 / ctx.trace_units
