"""Operations and bytes of one launch of the port's SAM rel-pos attention
kernel (``csrc/relpos_attention.cu``; K1 windowed, K2 global).

Operations: the two products, 2 * 2 * BH * N^2 * D.  Bytes: q, k, v and
the output (BH, N, D) and the rel-pos terms rel_h (BH, N, kh) and rel_w
(BH, N, kw), bf16, each read or written once.
"""


def ops(s: dict) -> float:
    return 4.0 * s["bh"] * s["n"] * s["n"] * s["d"]


def bytes_moved(s: dict, elem: int = 2) -> float:
    return float(elem * s["bh"] * s["n"] * (4 * s["d"] + s["kh"] + s["kw"]))
