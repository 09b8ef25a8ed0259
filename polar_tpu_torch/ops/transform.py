"""Batched polar transform (the XOR butterfly in the ±1 hard-symbol domain).

The port of ``polar_tpu.ops.transform``. The polar transform F^{⊗m} over
GF(2) is expressed on BPSK hard symbols (bit 0 ↔ +1, bit 1 ↔ -1), where
XOR becomes multiplication: stage h pairs element j with element j+h and
replaces the lower element by the product (``polar_encoder.hh:17-26``).
Each stage is one elementwise multiply over a ``(..., N/(2h), 2, h)``
view; the frame dimensions ride along untouched.
"""

from __future__ import annotations

import torch


def polar_transform(x, axis: int = -1):
    """Apply the N×N polar transform along ``axis`` (last or first).

    ``x``: (..., N) (``axis=-1``) or (N, ...) (``axis=0``) hard symbols in
    {-1, 0, +1} (any int or float dtype). ``axis=0`` is the element-major
    layout the CUDA kernels use: the code axis leads, frames trail.
    """
    n = x.shape[axis]
    if n & (n - 1):
        raise ValueError(f"N must be a power of two, got {n}")
    return polar_transform_stages(x, 1, n, axis=axis)


def polar_transform_stages(x, h_lo: int, h_hi: int, axis: int = -1):
    """Apply only the butterfly stages with ``h_lo <= h < h_hi``.

    Stage h is the Kronecker factor acting on index bit log2(h), so stages
    commute: the transform splits as (top stages) ∘ (bottom stages) in
    either order.
    """
    if axis == 0:
        n = x.shape[0]
        tail = x.shape[1:]
        h = h_lo
        while h < h_hi:
            v = x.reshape(n // (2 * h), 2, h, *tail)
            lo = v[:, 0] * v[:, 1]
            x = torch.stack([lo, v[:, 1]], dim=1).reshape(n, *tail)
            h *= 2
        return x
    if axis != -1:
        raise ValueError("axis must be 0 or -1")
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = h_lo
    while h < h_hi:
        v = x.reshape(*lead, n // (2 * h), 2, h)
        lo = v[..., 0, :] * v[..., 1, :]
        x = torch.stack([lo, v[..., 1, :]], dim=-2).reshape(*lead, n)
        h *= 2
    return x
