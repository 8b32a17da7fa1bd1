"""``flash_attention_roofline.<cell>``: the port's flash attention kernel
(``csrc/flash_attention.cu``, K7) against its roofline, at every launch the
configuration's shapes predict (the UNet's and the ControlNet's
self-attention on the levels the program sends to the kernel)."""

from gpubench.metrics._roofline import share

PATTERN = r"attention_tile_kernel<\d+, ?false>"


def read(ctx, metric):
    return share(ctx, "flash_attention", "flash_attention", PATTERN, 1)
