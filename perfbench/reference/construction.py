"""Polar code construction for the benchmark's reference, in NumPy.

The frozen set of the upstream test bench (xdsopl/polar ``testbench.cc``
lines 74-89, ``polar_freezer.hh`` lines 34-62): the design Es/N0 of a
rate-R code is ``10 log10(-ln(1 - R))`` plus an offset of 1.59175 dB, its
erasure probability ``exp(-10^(SNR/10))``; the erasure probabilities of
the bit channels evolve as ``pe(2 - pe)`` (left child) and ``pe^2`` (right
child), and the K most reliable channels carry information.

The probabilities are evolved as (log pe, log(1 - pe)), each exact where
the other saturates, so the ranking stays total at every level; ties go to
the lower leaf index. Written for the benchmark from the test bench's
description; it shares no code with the program under test.
"""

from __future__ import annotations

import math

import numpy as np


def design_erasure_probability(rate: float, offset_db: float) -> float:
    """The erasure probability of the test bench's design point."""
    snr_db = 10.0 * math.log10(-math.log(1.0 - rate)) + offset_db
    return math.exp(-(10.0 ** (snr_db / 10.0)))


def log_erasure(level: int, pe: float) -> tuple[np.ndarray, np.ndarray]:
    """(log pe, log(1 - pe)) of the 2^level bit channels, natural order."""
    lp = np.array([math.log(pe)])
    lq = np.array([math.log1p(-pe)])
    for _ in range(level):
        p = np.exp(lp)
        with np.errstate(divide="ignore", invalid="ignore"):
            from_q = np.log1p(-np.exp(2.0 * lq))      # log(1 - (1-pe)^2)
        left_lp = np.where(p < 0.5, lp + math.log(2.0) + np.log1p(-0.5 * p),
                           from_q)
        left_lq = 2.0 * lq
        right_lp = 2.0 * lp
        right_lq = lq + np.log1p(p)
        lp = np.stack([left_lp, right_lp], axis=1).reshape(-1)
        lq = np.stack([left_lq, right_lq], axis=1).reshape(-1)
    return lp, lq


def frozen_mask(level: int, k: int, offset_db: float = 1.59175) -> np.ndarray:
    """uint8 mask of 2^level leaves, 1 = frozen: all but the ``k`` most
    reliable, at the design point of rate ``k / 2^level``."""
    n = 1 << level
    if not 0 < k < n:
        raise ValueError(f"K={k} must lie in (0, {n})")
    lp, lq = log_erasure(level, design_erasure_probability(k / n, offset_db))
    order = np.lexsort((np.arange(n), -lq, lp))
    mask = np.ones(n, dtype=np.uint8)
    mask[order[:k]] = 0
    return mask
