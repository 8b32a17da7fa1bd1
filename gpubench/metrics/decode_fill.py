"""``decode_fill.<cell>``: the share of SAM's decode slots that held a real
box prompt in the traced sub-window: the sum of ``boxes`` over the sum of
``slots`` of the program's ``segment.decode`` spans that count both
(``SamPredictor.predict_device_state``: the prompts padded to the box
capacity)."""

from gpubench.metrics._program_spans import records


def read(ctx, metric):
    if ctx.trace is None:
        return None
    boxes = slots = 0
    for s in records(ctx):
        if s.name == "segment.decode" and {"boxes", "slots"} <= set(s.counts):
            boxes += s.counts["boxes"]
            slots += s.counts["slots"]
    return boxes / slots if slots else None
