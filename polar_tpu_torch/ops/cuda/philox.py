"""Philox4x32-10 and the bits → uniform / normal / symbol maps, in torch.

The plain version of ``csrc/philox.cuh``: the same words from the same
(key, counter), so the CUDA step kernel can be held against the eager
chain on identical random bits. Word w of frame f's stream is lane w % 4
of ``philox4x32_10(counter=(f, w // 4, call, 0), key=(seed0, seed1))``
(Salmon et al., SC'11). torch has no uint32 arithmetic to speak of and a
32×32-bit product overflows int64, so words are int64 tensors holding
values in [0, 2^32) and the products are formed from 16-bit halves.

The bit maps are those of ``polar_tpu/ops/pallas/step_kernel.py:83-149``
(``_bits_to_unit``, ``_sincos_2pi``, ``_bits_to_normals``,
``_bits_to_sym``) and ``channel_kernel.py:_normals``, operation for
operation in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the words ``b``, every partial product below 2^50."""
    p_lo = a * (b & 0xFFFF)            # < 2^48
    p_hi = a * (b >> 16)               # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    lo = mid & _MASK
    hi = (p_hi >> 16) + (mid >> 32)
    return hi & _MASK, lo


def seed_words(seeds) -> tuple[int, int]:
    """Two seed integers as the 32-bit key words a kernel takes."""
    return tuple(int(s) & _MASK for s in seeds)


def philox4x32_10(c0, c1, c2, c3, key: tuple[int, int]):
    """Ten Philox rounds over broadcastable int64 counter words; returns
    the four output words."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def frame_words(seeds: tuple[int, int], call: int, frames: int, count: int,
                device, *, first: int = 0, frame0: int = 0) -> torch.Tensor:
    """(frames, count) int64 words, frame-major: row i holds words
    ``first .. first + count - 1`` of frame ``frame0 + i``'s stream."""
    b0, b1 = first // 4, -(-(first + count) // 4)
    blk = torch.arange(b0, b1, dtype=torch.int64, device=device)[None, :]
    frame = torch.arange(frame0, frame0 + frames, dtype=torch.int64,
                         device=device)[:, None]
    shape = (frames, b1 - b0)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(frame.expand(shape), blk.expand(shape),
                          zero + (call & _MASK), zero, seeds)
    w = torch.stack([x.expand(shape) for x in words], dim=2).reshape(
        frames, 4 * (b1 - b0))
    return w[:, first - 4 * b0:first - 4 * b0 + count]


def random_bits(seeds: tuple[int, int], call: int, rows: int, batch: int,
                device, first: int = 0) -> torch.Tensor:
    """(rows, batch) int64 words, element-major: words ``first .. first +
    rows - 1`` of frame f as the step kernel draws them. ``first`` and
    ``rows`` must be multiples of 4."""
    if rows % 4 or first % 4:
        raise ValueError("first and rows must be multiples of 4")
    return frame_words(seeds, call, batch, rows, device,
                       first=first).t().contiguous()


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding u32 values → int32 words with the same 32 bits
    (values from 2^31 as their two's-complement negatives)."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _f32(x: float) -> float:
    return float(np.float32(x))


def bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in (0, 1]: top 24 bits plus half an ulp. Never 0,
    so ``log(u)`` is finite; the top 2^8 words round to exactly 1.0 in
    float32 (as in the JAX package, whose docstring says (0, 1))."""
    return ((b >> 8).to(torch.float32) + 0.5) * _f32(1.0 / (1 << 24))


def sincos_2pi(u: torch.Tensor):
    """(cos 2πu, sin 2πu) by quadrant reduction and Taylor polynomials
    (degree 8 and 9, remainder below 3e-8 on [-π/4, π/4])."""
    t = 4.0 * u
    k = torch.round(t)
    phi = (t - k) * _f32(math.pi / 2.0)
    x2 = phi * phi
    c = 1.0 + x2 * (_f32(-1 / 2) + x2 * (
        _f32(1 / 24) + x2 * (_f32(-1 / 720) + x2 * _f32(1 / 40320))))
    s = phi * (1.0 + x2 * (_f32(-1 / 6) + x2 * (
        _f32(1 / 120) + x2 * (_f32(-1 / 5040) + x2 * _f32(1 / 362880)))))
    ki = k.to(torch.int32)
    swap = (ki & 1) == 1
    sign_c = (1 - ((ki + 1) & 2)).to(torch.float32)
    sign_s = (1 - (ki & 2)).to(torch.float32)
    return sign_c * torch.where(swap, s, c), sign_s * torch.where(swap, c, s)


def bits_to_normals(b: torch.Tensor) -> torch.Tensor:
    """(2h, B) words → (2h, B) standard normals by Box-Muller: rows [0, h)
    give the radius, rows [h, 2h) the angle; the cos and sin outputs fill
    rows [0, h) and [h, 2h)."""
    h = b.shape[0] // 2
    u1 = bits_to_unit(b[:h])
    u2 = bits_to_unit(b[h:])
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = sincos_2pi(u2)
    return torch.cat([r * c, r * s], dim=0)


def bits_to_normals_cos(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Standard normals by the cosine-only Box-Muller of
    ``polar_tpu/ops/pallas/channel_kernel.py:_normals``: ``sqrt(-2 log u1)
    · cos 2πu2``, one normal from two independent words per element."""
    r = torch.sqrt(-2.0 * torch.log(bits_to_unit(b1)))
    return r * sincos_2pi(bits_to_unit(b2))[0]


def bits_to_sym(b: torch.Tensor) -> torch.Tensor:
    """Words → ±1 int8 symbols from the lowest bit (bit 1 → -1)."""
    return (1 - 2 * (b & 1)).to(torch.int8)
