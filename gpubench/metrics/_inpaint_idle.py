"""Card-idle time of the traced inpainting requests, split at the program's
``inpaint.loop`` spans (the solver loop), shared by ``loop_idle_ms`` and
``glue_idle_ms``.

As in :mod:`gpubench.metrics.idle_ms`, idle time lies on the card's clock
and spans on the host's, so the clocks are checked at the program's
``wait`` spans first.  Most of the sampler's waits are synchronises of the
stream, not reads: such a wait returns just after the card's last event,
whatever it is.  So every device event counts here as one a wait may
follow (in ``idle_ms`` only copies to the host do), and a wait's end must
lie within ``idle_ms.WAKE_US`` after the end of a device event, with the
card idle in between.
"""

from __future__ import annotations

from gpubench.metrics import idle_ms
from gpubench.metrics._program_spans import (intersect, length, records,
                                             requests_us, subtract, union)


def split(ctx):
    """(idle us inside ``inpaint.loop``, idle us outside it, the number of
    ``inpaint.step`` spans), cached on ``ctx``; None where there is no
    trace, no program span, or the clocks do not match."""
    if hasattr(ctx, "inpaint_idle"):
        return ctx.inpaint_idle
    ctx.inpaint_idle = None
    t = ctx.trace
    spans = records(ctx) if t is not None else []
    waits = [(s.start_us, s.end_us) for s in spans if s.name == "wait"]
    loops = union((s.start_us, s.end_us) for s in spans
                  if s.name == "inpaint.loop")
    if not waits or not loops:
        return None
    offset, n = idle_ms.clock_offset_us(
        [("DtoH", e.start_us, e.end_us) for e in t.events], waits)
    if offset is None:
        return None
    shift = offset if abs(offset) > idle_ms.TOLERANCE_US else 0.0
    busy = union((e.start_us - shift, e.end_us - shift) for e in t.events)
    idle = subtract(union(requests_us(t)), busy)
    steps = sum(1 for s in spans if s.name == "inpaint.step")
    ctx.inpaint_idle = (length(intersect(idle, loops)),
                        length(subtract(idle, loops)), steps)
    return ctx.inpaint_idle
