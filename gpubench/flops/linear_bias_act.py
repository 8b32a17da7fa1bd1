"""Operations and bytes of one ``mlp_gelu`` launch of the port's GEMM
kernel (``csrc/linear_bias_act.cu``, K3): fc1 with GELU, then fc2, each a
kernel.

Operations: 2 * M * K * H + 2 * M * H * N.  Bytes (bf16, each operand
read or written once per GEMM): fc1 reads x (M, K), w1 (H, K), b1 (H) and
writes h (M, H); fc2 reads h, w2 (N, H), b2 (N) and writes (M, N).
"""


def ops(s: dict) -> float:
    return 2.0 * s["m"] * s["h"] * (s["k"] + s["n"])


def bytes_moved(s: dict, elem: int = 2) -> float:
    m, k, h, n = s["m"], s["k"], s["h"], s["n"]
    fc1 = m * k + h * k + h + m * h
    fc2 = m * h + n * h + n + m * n
    return float(elem * (fc1 + fc2))
