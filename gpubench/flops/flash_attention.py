"""Operations and bytes of one launch of the port's flash attention kernel
(``csrc/flash_attention.cu``, K7): softmax(q k^T / sqrt(D)) v over (BH,
N, D), no bias.

Operations: the two products, 2 * 2 * BH * N^2 * D.  Bytes: q, k, v and
the output (BH, N, D), bf16, each read or written once.
"""


def ops(s: dict) -> float:
    return 4.0 * s["bh"] * s["n"] * s["n"] * s["d"]


def bytes_moved(s: dict, elem: int = 2) -> float:
    return float(elem * 4 * s["bh"] * s["n"] * s["d"])
