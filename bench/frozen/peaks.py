"""The H100's published peaks (NVIDIA's data sheet, SXM part, dense) and
the roofline bound, frozen from ``chip_smoke.py``'s ``bound_ms``."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def bound_s(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)
