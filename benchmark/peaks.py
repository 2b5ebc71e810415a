"""The yardstick of the rooflines: the H100's published peaks and the
bytes each of the port's kernels needs for a launch, counted from its
shapes."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (at its full 700 W power limit): 80 GB of HBM3 at
# 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12

# the kernels of each K-number as the device trace names them
K1_KERNELS = ("scan_counts_kernel", "expand_kernel")
K2_KERNELS = ("expand_lanes_kernel",)


def k1_bytes(n: int, d: int) -> int:
    """K1 (``fused_expand``) at ``n`` particles and ``d`` float32 planes:
    the probabilities, the uniform and the values read once, the resampled
    values and the int32 ancestors written once."""
    return 4 * n + 4 + 4 * d * n + 4 * d * n + 4 * n


def k2_bytes(n: int, lanes: int, d: int) -> int:
    """K2 (``fused_expand_lanes``) at ``n`` particles, ``lanes`` lanes and
    ``d`` planes: each lane's probabilities, its uniform and its values read
    once, its resampled values and ancestors written once."""
    return 4 * n * lanes + 4 * lanes + 4 * d * n * lanes + 4 * d * n * lanes + 4 * n * lanes


def least_seconds(total_bytes: int) -> float:
    """The least time the card could move ``total_bytes`` in: the kernels
    do no arithmetic worth a compute bound."""
    return total_bytes / HBM_BYTES_PER_S
