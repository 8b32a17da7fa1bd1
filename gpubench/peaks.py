"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, SXM parts, dense rates at the full power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak(kind: str) -> dict:
    """The peaks of card ``kind`` (the H100's where the name is not in the
    table, e.g. on the CPU in tests)."""
    return PEAKS.get(kind, PEAKS[DEFAULT])


def bound_s(ops: float, nbytes: float, kind: str = DEFAULT) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    p = peak(kind)
    return max(ops / p["bf16_flops"], nbytes / p["hbm_bytes_s"])
