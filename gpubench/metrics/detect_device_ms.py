"""``detect_device_ms.<cell>``: device ms per sketch of the kernels
launched inside the entry's ``detect`` span (``GDinoDetector``)."""

from gpubench.metrics._span import device_ms_per_unit


def read(ctx, metric):
    return device_ms_per_unit(ctx, "detect")
