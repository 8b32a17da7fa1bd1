"""``bucket_fill.<cell>``: the share of the sampler's bucket slots that held
a real layer in the traced sub-window: the sum of ``layers`` over the sum
of ``slots`` of the program's ``inpaint.loop`` spans
(``ControlNetInpaintPipeline``'s solver loop over one bucket)."""

from gpubench.metrics._program_spans import records


def read(ctx, metric):
    if ctx.trace is None:
        return None
    layers = slots = 0
    for s in records(ctx):
        if s.name == "inpaint.loop" and {"layers", "slots"} <= set(s.counts):
            layers += s.counts["layers"]
            slots += s.counts["slots"]
    return layers / slots if slots else None
