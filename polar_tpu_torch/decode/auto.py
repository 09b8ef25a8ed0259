"""Decoder selection by device, code size, output track and batch.

* CUDA — the hand-written whole-code Fast-SSC kernel
  (:mod:`polar_tpu_torch.ops.cuda.decoder_kernel`), one launch per call,
  for every output mode; from ``HYBRID_MIN_LEVEL`` up, the hybrid decoder
  (eager top levels, subtree kernels at and below ``HYBRID_KERNEL_LEVEL``)
  where the H100 timings in PERF.md put it ahead, for the frame-major
  decoders built here and for the front path's lane-major ones alike;
  :data:`AUTO_DECODERS` then moves a (level, track) to another kernel
  style (the shared-memory scratch kernel, the interpreter) below or from
  :data:`BIG_BATCH` frames a call, where the same timings put that style
  ahead;
* CPU — the eager decoder (:func:`~polar_tpu_torch.decode.fastssc.make_fastssc_decoder`).

All are bit-exact with each other and with ``polar_tpu``; the choice is
speed only. The JAX package's per-level tile, VMEM and hybrid tables
(``_HYBRID_KL_*``, ``_HYBRID_MIN_LEVEL``) are facts about the TPU and do
not carry over.
"""

from __future__ import annotations

import torch

from ..code.compiler import compile_program
from ..code.construction import PolarCode
from ..ops.cuda import decoder_kernel
from ..ops.cuda.interp_kernel import make_interp_decoder
from .fastssc import OUTPUTS, make_fastssc_decoder


# Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): at
# Polar(131072, 65536), B = 4096, the hybrid at kernel level 9 took 106 ms
# (u) and 141 ms (cw) per decode, the whole-code kernel 567 and 1060 ms;
# kernel levels 8 and 10 came within 50 %, 6 and 12-16 lost. At levels
# 13-16 it won as well (2.5-6.8x). Below, one decode of full-range LLRs
# (python -m polar_tpu_torch.utils.step_ab --decoders-only), whole-code
# against hybrid, u / cw, frame-major entry: m = 9 0.73 / 1.00 against
# 0.89 / 1.01 ms at B = 32768, 0.39 / 0.49 against 0.86 / 0.89 at B = 4096;
# m = 10 2.09 / 3.21 against 1.99 / 2.63 at B = 32768, 0.77 / 1.16 against
# 0.71 / 1.11 at B = 4096; m = 11, 12 the hybrid by 1.1-2.6x. The
# lane-major entry (the front path's) ranks them alike, but for m = 9 cw
# at B = 32768 (0.82 against 0.78 ms). The front path's branches follow
# this threshold too (polar_tpu_torch.ber.front_branch).
HYBRID_MIN_LEVEL = 10
HYBRID_KERNEL_LEVEL = 9

# The decoder by (level, codeword track): below BIG_BATCH frames a call, then
# from it; "ssa" / "scratch" / "interp" the whole-code kernel in that style
# (the interpreter at INTERP_SUBTREE_LEVEL), "hybrid[-style]" the hybrid at
# hybrid_kernel_level. Pairs not listed take "ssa" below HYBRID_MIN_LEVEL and
# "hybrid" from it. From the decoder A/B (python -m
# polar_tpu_torch.utils.step_ab --decoders-only --levels 6-17; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6): a style moves in where it beat the current
# decoder, mean of two readings, by more than either's spread and by more
# than 1 %, in one entry (frame- or lane-major) and by the mean in the other.
# Lane-major ms, B = 4096 / 32768, new against old:
# - u, m = 6..9: scratch 0.041 / 0.042 against 0.057 / 0.056 (m = 6) ...
#   0.218 / 0.482 against 0.273 / 0.563 (m = 9);
# - u, m = 10, 11 below BIG_BATCH: scratch 0.518, 1.076 against the hybrid's
#   0.688, 1.457 (at 32768 the hybrid stays: 1.65 against 1.88 at m = 10);
# - cw, m = 9 from BIG_BATCH: the interpreter, 0.755 against 0.812;
# - below BIG_BATCH, the hybrid in the scratch style: u m = 13, 15, 16, 17
#   (7.83, 23.91, 49.98, 101.47 against 8.26, 25.78, 54.84, 109.89; m = 14
#   tied), cw m = 13..17 (7.35, 15.05, 33.05, 64.90, 134.62 against 9.03,
#   17.20, 35.98, 70.39, 140.90);
# - cw, m = 13, 14 from BIG_BATCH: the hybrid in the interp style, 28.49,
#   63.49 against 28.99, 64.31.
BIG_BATCH = 16384
INTERP_SUBTREE_LEVEL = 5
AUTO_DECODERS = {
    **{(m, False): ("scratch", "scratch") for m in range(6, 10)},
    (9, True): ("ssa", "interp"),
    (10, False): ("scratch", "hybrid"), (11, False): ("scratch", "hybrid"),
    (13, False): ("hybrid-scratch", "hybrid"),
    (13, True): ("hybrid-scratch", "hybrid-interp"),
    (14, True): ("hybrid-scratch", "hybrid-interp"),
    **{(m, cw): ("hybrid-scratch", "hybrid")
       for m in (15, 16, 17) for cw in (False, True)},
}


def hybrid_kernel_level(level: int) -> int:
    """The hybrid's kernel level for a code of this level: the measured
    ``HYBRID_KERNEL_LEVEL``, cut to ``level - 1`` for smaller codes."""
    return min(HYBRID_KERNEL_LEVEL, level - 1)


def make_kernel_decoder(code: PolarCode, *, output: str = "u",
                        output_dtype=torch.int8, style: str = "ssa"):
    """The CUDA kernel decoder with the eager decoder's interface:
    ``decode(llrs)`` on frame-major ``(B, N)`` int8 LLRs and
    ``decode.lane_major(llr_t)`` on element-major ``(N, B)`` ones (no
    transposes). The kernel always runs element-major; the frame-major
    entry transposes in and out. ``style``: ``"ssa"`` or ``"scratch"``
    (the shared-memory kernel: u output only, N <= 2^11; it raises
    ``ValueError`` otherwise, as ``make_pallas_decoder`` does)."""
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    if style not in decoder_kernel.STYLES:
        raise ValueError(f"unknown kernel style {style!r}")
    if style == "scratch":
        if output != "u":
            raise ValueError("non-u output modes require the SSA kernel style")
        decoder_kernel.scratch_frames(code.N)
    program = compile_program(code)
    frozen = code.frozen
    want_cw = output != "u"

    def lane_major(llr_t):
        mesg, cw = decoder_kernel.decode(program, frozen, llr_t, want_cw,
                                         style)
        if output == "u":
            return mesg.to(output_dtype)
        if output == "systematic":
            info = torch.as_tensor(code.info_indices, device=cw.device)
            return cw[info].to(output_dtype)
        if output == "codeword":
            return cw.to(output_dtype)
        return mesg.to(output_dtype), cw.to(output_dtype)

    def decode(llrs):
        if llrs.ndim != 2:
            raise ValueError("kernel decoder expects (batch, N) LLRs")
        out = lane_major(llrs.t().contiguous())
        if isinstance(out, tuple):
            return tuple(o.t().contiguous() for o in out)
        return out.t().contiguous()

    decode.lane_major = lane_major
    return decode


def decoder_names(level: int, cw: bool) -> tuple[str, str]:
    """The decoders for this level and track, below and from
    :data:`BIG_BATCH` frames."""
    default = "hybrid" if level >= HYBRID_MIN_LEVEL else "ssa"
    return AUTO_DECODERS.get((level, cw), (default, default))


def kernel_style(level: int, cw: bool, batch: int, hybrid: bool) -> str:
    """The kernel style of the hybrid (``hybrid``) or of the whole-code
    kernel decoder for a call of ``batch`` frames: :func:`decoder_names`'
    where it names that decoder in a style the decoder has, else
    ``"ssa"``."""
    name = decoder_names(level, cw)[batch >= BIG_BATCH]
    if hybrid:
        return (name.partition("-")[2] or "ssa") if name.startswith(
            "hybrid") else "ssa"
    return name if name in decoder_kernel.STYLES else "ssa"


def make_named_decoder(code: PolarCode, name: str, output: str,
                       output_dtype=torch.int8):
    """``(decode, description)``: the CUDA decoder of one of
    :data:`AUTO_DECODERS`' names."""
    if name in ("ssa", "scratch"):
        return (make_kernel_decoder(code, output=output,
                                    output_dtype=output_dtype, style=name),
                "cuda-fastssc" if name == "ssa" else "cuda-scratch")
    if name == "interp":
        return (make_interp_decoder(code, subtree_level=INTERP_SUBTREE_LEVEL,
                                    output=output, output_dtype=output_dtype),
                f"cuda-interp-sl{INTERP_SUBTREE_LEVEL}")
    style = name.partition("-")[2] or "ssa"
    kl = hybrid_kernel_level(code.level)
    return (make_fastssc_decoder(code, output=output, output_dtype=output_dtype,
                                 kernel_level=kl, kernel_style=style),
            f"cuda-hybrid-kl{kl}" + ("" if style == "ssa" else f"-{style}"))


def _by_batch(small, big):
    """One decoder of two: ``small`` for calls below :data:`BIG_BATCH`
    frames, ``big`` from it, for both entries."""

    def decode(llrs):
        return (small if llrs.shape[0] < BIG_BATCH else big)(llrs)

    def lane_major(llr_t):
        return (small if llr_t.shape[1] < BIG_BATCH else big).lane_major(llr_t)

    decode.lane_major = lane_major
    return decode


def make_auto_decoder(code: PolarCode, *, output: str = "u",
                      output_dtype=torch.int8, device):
    """Best decoder for ``code`` on ``device``: returns ``(decode_fn,
    description)``. Inputs are int8 LLRs. On a card the decoder is
    :data:`AUTO_DECODERS`' for the output's track, by the batch of each
    call."""
    device = torch.device(device)
    if device.type != "cuda":
        return (make_fastssc_decoder(code, output=output,
                                     output_dtype=output_dtype), "eager")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    small, big = decoder_names(code.level, output != "u")
    if small == big:
        return make_named_decoder(code, small, output, output_dtype)
    (dec_s, desc_s), (dec_b, desc_b) = (
        make_named_decoder(code, name, output, output_dtype)
        for name in (small, big))
    return (_by_batch(dec_s, dec_b),
            f"{desc_s} below {BIG_BATCH} frames, {desc_b} from it")
