"""``relpos_attention_roofline.<cell>``: the SAM rel-pos attention kernel
(``csrc/relpos_attention.cu``, K1 and K2) against its roofline."""

from gpubench.metrics._roofline import share

PATTERN = r"attention_tile_kernel<\d+, ?true>"


def read(ctx, metric):
    return share(ctx, "relpos_attention", "relpos_attention", PATTERN, 1)
