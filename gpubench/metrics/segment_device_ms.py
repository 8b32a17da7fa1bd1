"""``segment_device_ms.<cell>``: device ms per sketch of the kernels
launched inside the entry's ``segment`` spans (``SamPredictor``: the
batched encode and the box decode)."""

from gpubench.metrics._span import device_ms_per_unit


def read(ctx, metric):
    return device_ms_per_unit(ctx, "segment")
