"""The card's peaks, for the roofline shares (NVIDIA H100 SXM data sheet,
dense rates, at the full power limit of 700 W).

None of the program's kernels uses the tensor cores, so every 32-bit
integer or float operation is counted at the rate outside them.
"""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take for this work, and which of the
    two bounds it: the larger of bytes over the memory rate and operations
    over the operation rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
