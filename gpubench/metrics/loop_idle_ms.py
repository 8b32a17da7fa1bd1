"""``loop_idle_ms.<cell>``: card-idle ms per solver step while the host was
inside the program's ``inpaint.loop`` spans (the diffusion pipeline's
solver loop), in the traced sub-window; the clocks checked as
:mod:`gpubench.metrics._inpaint_idle` says."""

from gpubench.metrics._inpaint_idle import split


def read(ctx, metric):
    got = split(ctx)
    if got is None or not got[2]:
        return None
    return got[0] / 1e3 / got[2]
