"""``linear_bias_act_roofline.<cell>``: the GEMM kernel
(``csrc/linear_bias_act.cu``, K3) of SAM's fused MLP against its
roofline."""

from gpubench.metrics._roofline import share

PATTERN = r"gemm_bias_act_kernel<"


def read(ctx, metric):
    return share(ctx, "linear_bias_act", "mlp_gelu", PATTERN, 2)
