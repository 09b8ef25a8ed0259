"""Throughput measurement by the chained slope method.

The port of ``polar_tpu.utils.benchmark`` (``measure_decode_fps``,
``measure_step_rate`` and their slope core):

* ``iters`` decodes are chained, each input perturbed by the previous
  output (a true data dependency, nothing can be skipped or cached);
* on a CUDA device the run is timed with CUDA events recorded on the
  current stream, so the time is the card's and not the host's enqueue;
  on the CPU with the host clock;
* the reported time is the slope between a 1-iteration and an
  n-iteration run, which cancels per-call constants.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F


def elapsed_seconds(fn, device) -> float:
    """Seconds ``fn()`` takes on ``device``: CUDA events around it on a
    CUDA device, the host clock on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# Cycles a second of torch.cuda._sleep's spin, at most: an H100 SXM's
# highest SM clock (1.98 GHz), so a hold is never shorter than asked.
HOLD_CYCLES_PER_S = 2.0e9


def queued_seconds(fn, reps: int) -> float:
    """Seconds one call of ``fn`` keeps the current CUDA device busy, its
    host time hidden: a spin kernel holds the current stream while ``reps``
    calls are queued behind it, so the CUDA events around them see their
    kernels back to back. ``fn`` must not synchronise with the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(HOLD_CYCLES_PER_S * (2 * reps * host + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _chained_runner(decode_fn, n_out_pad):
    """runner(x, iters): ``iters`` decodes, each fed the previous input
    plus its zero-padded output (int8 wraparound is fine: only the
    dependency matters)."""

    def runner(x, iters):
        for _ in range(iters):
            out = decode_fn(x)
            x = x + F.pad(out, (0, n_out_pad)).to(x.dtype)
        return x

    return runner


def measure_decode_fps(decode_fn, llrs, *, iters: int = 16,
                       warmup: bool = True, repeats: int = 3,
                       max_iters: int = 4096,
                       max_rel_spread: float = 0.25) -> float:
    """Frames/s of ``decode_fn`` on the batch ``llrs`` ((B, N) → (B, K)).

    If the n-iteration run is not clearly slower than the 1-iteration run,
    or the slope is inconsistent across repeats, the iteration count grows
    geometrically until the measurement is resolvable (acceptance as in
    :func:`slope_seconds_per_iter`)."""
    b, n = llrs.shape
    k = decode_fn(llrs[:1]).shape[-1]
    runner = _chained_runner(decode_fn, n - k)

    def timed(it):
        return elapsed_seconds(lambda: runner(llrs, it), llrs.device)

    slope = slope_seconds_per_iter(timed, iters, warmup=warmup,
                                   repeats=repeats, max_iters=max_iters,
                                   max_rel_spread=max_rel_spread)
    return b / slope


def slope_seconds_per_iter(timed, iters, *, warmup=True, repeats=3,
                           max_iters=4096, max_rel_spread=0.25) -> float:
    """The adaptive chained-slope core: ``timed(it)`` runs an
    it-iteration chain and returns seconds. The accepted per-iteration
    slope must dominate the per-call constant
    (``best * (iters - 1) > 3 * median(t1)``) and be consistent across
    repeats (``(max - min) / min <= max_rel_spread``), else the iteration
    count grows fourfold."""
    if warmup:
        timed(1)
        timed(iters)
    while True:
        slopes, t1s = [], []
        for _ in range(repeats):
            t1 = timed(1)
            tn = timed(iters)
            t1s.append(t1)
            slopes.append((tn - t1) / (iters - 1))
        best = min(slopes)
        t1s.sort()
        t1_med = t1s[len(t1s) // 2]
        dominates = best > 0 and best * (iters - 1) > 3 * abs(t1_med)
        consistent = (len(slopes) < 2
                      or (max(slopes) - best) <= max_rel_spread * best)
        if dominates and consistent:
            return best
        if iters >= max_iters:
            if best <= 0:
                raise RuntimeError(
                    f"throughput not resolvable: slope {best:.3g}s/iter at "
                    f"{iters} iters (workload too small vs timer noise)")
            return best
        iters = min(iters * 4, max_iters)


def measure_step_rate(step, gen, snr_db, batch: int, *, device,
                      iters: int = 16, warmup: bool = True, repeats: int = 3,
                      max_iters: int = 4096,
                      max_rel_spread: float = 0.25) -> float:
    """Frames/s of the whole Monte-Carlo step (message, encode, AWGN,
    decode, counters): the campaign's rate, against
    :func:`measure_decode_fps`'s decode-only rate
    (``polar_tpu/utils/benchmark.py:135-171``).

    ``step`` is a :func:`polar_tpu_torch.ber.make_step` callable and
    ``gen`` the host generator its steps draw their seeds from. A timed
    run chains ``it`` steps with :func:`polar_tpu_torch.ber.chain_steps`
    (counters summed on the device) and ends with a host pull of the sum,
    timed by CUDA events on a card and the host clock on the CPU; the
    slope acceptance is :func:`slope_seconds_per_iter`'s."""
    from ..ber import chain_steps

    multi = chain_steps(step)

    def timed(it):
        return elapsed_seconds(
            lambda: int(multi(gen, snr_db, batch, it)["uncorrected_errors"]),
            device)

    slope = slope_seconds_per_iter(timed, iters, warmup=warmup,
                                   repeats=repeats, max_iters=max_iters,
                                   max_rel_spread=max_rel_spread)
    return batch / slope
