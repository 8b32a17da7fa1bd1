"""``host_wait_ms.<cell>``: host ms per sketch spent inside the program's
``wait`` spans (``inklayer_tpu_torch.spans``: the host blocked on the
card, at a ``.cpu()`` read, a read-back or a synchronise) in the traced
sub-window."""

from gpubench.metrics._program_spans import length, records, union


def read(ctx, metric):
    if ctx.trace is None or not ctx.trace_units:
        return None
    waits = [(s.start_us, s.end_us) for s in records(ctx)
             if s.name == "wait"]
    if not waits:
        return None
    return length(union(waits)) / 1e3 / ctx.trace_units
