"""Decoder selection by device, code size, output track and batch.

* CUDA — the hand-written whole-code Fast-SSC kernel
  (:mod:`polar_tpu_torch.ops.cuda.decoder_kernel`: the tile kernel up to
  its ``WHOLE_MAX_LEVEL``, the walk above), one launch per call,
  for every output mode; from ``HYBRID_MIN_LEVEL`` up, the hybrid decoder
  (eager top levels, subtree kernels at and below ``HYBRID_KERNEL_LEVEL``)
  where the H100 timings in PERF.md put it ahead, for the frame-major
  decoders built here and for the front path's lane-major ones alike;
  :data:`AUTO_DECODERS` then moves a (level, track) to another kernel
  style (the shared-memory scratch kernel, the interpreter) below or from
  :data:`BIG_BATCH` frames a call, where the same timings put that style
  ahead;
* CPU — the eager decoder (:func:`~polar_tpu_torch.decode.fastssc.make_fastssc_decoder`).

The input's dtype picks the arithmetic, as the eager decoder's does:
integer LLRs saturating int8, float ones min-sum. On a card float32 LLRs
of the u track go to the float kernel (``decoder_kernel.decode_f32``, up
to its ``F32_MAX_LEVEL``); higher levels and the codeword outputs in
float32 run the eager decoder, and other float dtypes raise.

All are bit-exact with each other and with ``polar_tpu``; the choice is
speed only. The JAX package's per-level tile, VMEM and hybrid tables
(``_HYBRID_KL_*``, ``_HYBRID_MIN_LEVEL``) are facts about the TPU and do
not carry over.
"""

from __future__ import annotations

import functools

import torch

from ..code.compiler import compile_program
from ..code.construction import PolarCode
from ..ops.cuda import decoder_kernel
from ..ops.cuda.interp_kernel import make_interp_decoder
from ..utils.profiling import annotate
from .fastssc import OUTPUTS, frame_major, make_fastssc_decoder


# Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): at
# Polar(131072, 65536), B = 4096, the hybrid at kernel level 9 took 106 ms
# (u) and 141 ms (cw) per decode, the whole-code kernel (then the walk) 567
# and 1060 ms; kernel levels 8 and 10 came within 50 %, 6 and 12-16 lost.
# The whole-code kernel is the tile kernel up to
# decoder_kernel.WHOLE_MAX_LEVEL. In the decoder A/B below it beat the
# hybrid at m = 10, 11 and 12 in both tracks, at both batches and in both
# entries (lane-major ms, B = 4096 / 32768, u then cw: m = 10 0.118 / 0.447
# and 0.150 / 0.712 against the hybrid's 0.828 / 1.670 and 1.060 / 2.218;
# m = 12 0.751 / 4.293 and 1.001 / 7.821 against 4.185 / 10.210 and
# 4.472 / 12.496), and at m = 13 on the u track (2.958 / 22.916 against the
# scratch hybrid's 7.500 and the hybrid's 23.581), so the hybrid starts at
# m = 14 (m = 13 cw from BIG_BATCH: AUTO_DECODERS). The front path's
# branches follow this threshold too (polar_tpu_torch.ber.front_branch),
# and take the interpreter's decode+count for systematic codes where
# AUTO_DECODERS names the interpreter on the codeword track at every batch.
HYBRID_MIN_LEVEL = 14
HYBRID_KERNEL_LEVEL = 9

# The decoder by (level, codeword track): below BIG_BATCH frames a call, then
# from it; "ssa" / "scratch" / "interp" the whole-code kernel in that style
# (the interpreter at INTERP_SUBTREE_LEVEL), "hybrid[-style]" the hybrid at
# hybrid_kernel_level. Pairs not listed take "ssa" below HYBRID_MIN_LEVEL and
# "hybrid" from it. From the decoder A/B (python -m
# polar_tpu_torch.utils.step_ab --decoders-only; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6): a style moves in where it beat the current decoder,
# mean of two readings, by more than either's spread and by more than 1 %,
# in one entry (frame- or lane-major) and by the mean in the other.
# Lane-major ms, B = 4096 / 32768, new against old. The tile kernel ("ssa",
# --levels 6-12, then with every arm run once before its readings --levels
# 6-13) moved in for
# - u, m = 7 below BIG_BATCH: 0.037 against the scratch kernel's 0.062;
# - u, m = 8, 9 from BIG_BATCH: 0.093, 0.195 against scratch's 0.138, 0.488;
# - cw, m = 9 from BIG_BATCH: 0.282 against the interpreter's 0.777;
# - m = 10, 11 below BIG_BATCH (u; scratch before): 0.118, 0.220 against
#   0.514, 1.079;
# - u, m = 8, 9 below BIG_BATCH (6-13): 0.056, 0.070 against scratch's
#   0.113, 0.231; frame-major 0.085, 0.118 against 0.145, 0.274 (in 6-12 it
#   trailed frame-major by the mean, its first reading 2.3-6.4x its second);
# - m = 13 (6-13), u: above; cw below BIG_BATCH: 3.708 against the scratch
#   hybrid's 10.738;
# and stayed out of u m = 6 (scratch 0.046 / 0.048 against 0.099 / 0.053),
# u m = 7 from BIG_BATCH (0.074 against 0.090) and cw m = 13 from BIG_BATCH
# (28.649 against the interp hybrid's 28.520).
# From the earlier A/B (--levels 6-17, the walk as "ssa", the walk as the
# SSA hybrid's subtree kernel): the scratch hybrid below BIG_BATCH at u
# m = 13, 15, 16, 17 and cw m = 13..17; the interp hybrid for cw m = 13, 14
# from BIG_BATCH. With the tile kernel as the SSA hybrid's subtree kernel
# (--levels 13-17, the walk hybrid an arm; frame- / lane-major ms, tile
# hybrid against the style it replaced) the SSA hybrid moved in for
# - u and cw, m = 13 from BIG_BATCH: u 23.316 / 19.239 against the
#   whole-code kernel's 25.764 / 22.898; cw 25.885 / 22.118 against the
#   interp hybrid's 32.128 / 28.272 (and the whole-code kernel's 28.665);
# - cw, m = 14 (B = 4096 / 32768, lane-major): 13.961 / 52.760 against the
#   scratch hybrid's 14.932 and the interp hybrid's 63.168; frame-major
#   14.205 against 15.997;
# - cw m = 15, 16, 17 below BIG_BATCH: 30.205 / 28.088, 55.224 / 56.791,
#   102.632 / 111.002 against the scratch hybrid's 33.014 / 31.240,
#   69.881 / 65.821, 140.835 / 132.603;
# - u m = 16, 17 below BIG_BATCH: 46.923 / 42.591, 99.547 / 91.799 against
#   the scratch hybrid's 50.596 / 47.514 and 102.922 / 97.123;
# and stayed out of u m = 15 below BIG_BATCH (24.541 / 20.664 against the
# scratch hybrid's 24.250 / 23.702: behind frame-major by the mean, ahead
# lane-major by less than its own spread, 16.967-24.362) and m = 13 below
# BIG_BATCH (the whole-code kernel's 2.926 / 3.660, u / cw lane-major,
# against 5.031 / 5.870). At u m = 14 below BIG_BATCH it stays the default:
# the scratch hybrid led frame-major (11.803 against 12.730) and trailed
# lane-major (11.596 against 11.338). The walk hybrid led no cell.
# With the scratch style redesigned as the packed tile kernel at the shapes
# of decoder_kernel.SCRATCH_TABLE (its byte kernel, since deleted, an arm;
# --decoders-only --levels 6-15; frame- / lane-major ms, each the mean of
# two readings) the scratch kernel moved in for
# - u, m = 8, 9, 10, 11 from BIG_BATCH (B = 32768): 0.149 / 0.068,
#   0.337 / 0.169, 0.745 / 0.407, 2.033 / 1.334 against the tile kernel's
#   0.176 / 0.094, 0.364 / 0.192, 0.779 / 0.441, 2.056 / 1.357 (the byte
#   kernel 0.224 / 0.138, 0.680 / 0.479, 2.194 / 1.877, 10.952 / 10.386);
#   at m = 9..11 it is the tile kernel's own instance, at 8, 4 and 2 warps
#   a block where "ssa" takes 2, 1 and 1;
# and stayed where it was at u m = 6 (scratch 0.062 / 0.032 at B = 4096,
# 0.055 / 0.033 at 32768, host-bound, spread to 0.024), u m = 7 from
# BIG_BATCH (0.079 / 0.039 against the byte kernel's 0.112 / 0.069), u
# m = 15 below BIG_BATCH (the scratch hybrid 24.425 / 22.532, the SSA
# hybrid 22.376 / 22.302 with spreads of 4.3 / 2.9, the byte hybrid
# 24.732 / 23.234). It led u m = 13, 14 from BIG_BATCH by less than 1 %
# (21.961 / 19.117 and 51.110 / 45.283 against the SSA hybrid's
# 22.102 / 19.271 and 51.304 / 45.476) and no other cell.
# With the interpreter as the tile kernel (its whole program in one launch:
# grid entries above level 11, tile runs below; arms "interp sl9" and
# "interp sl10", --decoders-only --levels 13-17) it moved in at subtree
# level 10 (sl9 trailed it by about 1 % everywhere) for every cell
# measured, both tracks, by 2.0-5.1x and beyond every spread (frame- /
# lane-major ms, interp against the decoder it replaced):
# - m = 13, B = 4096 (the tile kernel before): u 1.563 / 1.219 against
#   3.249 / 2.914, cw 1.901 / 1.474 against 4.078 / 3.660; from BIG_BATCH
#   (the hybrid before; B = 32768): u 7.876 / 5.003 against 22.075 /
#   19.205, cw 11.157 / 7.355 against 25.870 / 22.097;
# - m = 14 (the hybrid): B = 4096 u 3.133 / 2.467 against 10.232 /
#   12.277, cw 3.909 / 2.982 against 11.559 / 11.949; B = 32768 u 16.484 /
#   10.708 against 51.186 / 45.395, cw 23.784 / 16.079 against 60.460 /
#   52.725;
# - m = 15..17 below BIG_BATCH (B = 4096): u m = 15 6.277 / 4.914 against
#   the scratch hybrid's 17.669 / 20.721; cw m = 15 8.068 / 6.173 against
#   the hybrid's 30.803 / 33.671; m = 16 u 12.985 / 9.928, cw 16.763 /
#   12.649 against 47.316 / 42.853, 49.544 / 50.698; m = 17 u 25.811 /
#   20.139, cw 34.345 / 26.403 against 91.156 / 80.641, 102.382 / 104.078;
# - m = 15..17 from BIG_BATCH (the hybrid before; a second call, --levels
#   15-17 --batches 16384 --arms "interp sl10,hybrid kl9"; B = 16384): u
#   m = 15 17.989 / 12.302 against 57.310 / 51.581, m = 16 37.502 / 25.877
#   against 129.178 / 117.543, m = 17 77.331 / 54.030 against 299.472 /
#   254.985; cw m = 15 24.672 / 16.946 against 67.420 / 59.670, m = 16
#   52.322 / 36.473 against 152.300 / 136.331, m = 17 109.965 / 78.392
#   against 327.927 / 296.054.
# From m = 18 nothing is measured, and the hybrid stays the default.
BIG_BATCH = 16384
INTERP_SUBTREE_LEVEL = 10
AUTO_DECODERS = {
    (6, False): ("scratch", "scratch"), (7, False): ("ssa", "scratch"),
    **{(m, False): ("ssa", "scratch") for m in (8, 9, 10, 11)},
    **{(m, cw): ("interp", "interp") for m in range(13, 18)
       for cw in (False, True)},
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
    transposes). On the u track of a kernel with a frame-major layout
    (``decoder_kernel.has_frames``) the frame-major entry on a card hands
    the kernel ``(B, N)`` and takes ``(B, K)`` back; everywhere else
    (CPU tensors, the walk, the cw outputs) the kernel runs element-major
    and the entry transposes in and out (``fastssc.frame_major``).
    ``style``: ``"ssa"``, ``"walk"`` or ``"scratch"`` (the shared-memory
    kernel: u output only, N <= 2^11; it raises ``ValueError`` otherwise,
    as ``make_pallas_decoder`` does)."""
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

    decode = frame_major(lane_major, "kernel decoder")
    if output == "u" and decoder_kernel.has_frames(style, code.N):
        decode = _frames_entry(decode, program, frozen, style, output_dtype)
    decode.lane_major = lane_major
    decode.plan = functools.partial(decoder_kernel.plan, program,
                                    style=style, want_cw=want_cw)
    return decode


def _frames_entry(transposing, program, frozen, style, output_dtype):
    """The frame-major entry of a kernel's frame-major u track: on a card
    the kernel reads ``(B, N)`` and writes ``(B, K)`` itself, under the
    span ``decode``; off it the ``transposing`` entry."""

    def decode(llrs):
        if llrs.device.type != "cuda":
            return transposing(llrs)
        if llrs.ndim != 2:
            raise ValueError("kernel decoder expects (batch, N) LLRs")
        with annotate("decode"):
            mesg, _ = decoder_kernel.decode(program, frozen, llrs.contiguous(),
                                            False, style, layout="frames")
            return mesg.to(output_dtype)

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
    if name in decoder_kernel.STYLES:
        return (make_kernel_decoder(code, output=output,
                                    output_dtype=output_dtype, style=name),
                "cuda-fastssc" if name == "ssa" else f"cuda-{name}")
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


def _by_dtype(int8, code: PolarCode, output: str, output_dtype):
    """The card's decoder ``int8`` for integer LLRs, and the route of
    float32 ones: ``(decode, "cuda-f32")`` where the float kernel takes
    them (the u track up to ``decoder_kernel.F32_MAX_LEVEL``, frame-major
    ``(B, N)`` only), else ``(decode, "eager")``: the eager decoder in
    float min-sum, built at its first call. Other float dtypes, and float32
    that is not 2-D, raise ``ValueError``."""
    kernel = output == "u" and code.level <= decoder_kernel.F32_MAX_LEVEL
    built = {}

    def plain():
        if "eager" not in built:
            built["eager"] = make_fastssc_decoder(code, output=output,
                                                  output_dtype=output_dtype)
        return built["eager"]

    def check(llrs):
        if llrs.dtype != torch.float32 or llrs.ndim != 2:
            raise ValueError(f"float LLRs on a card are 2-D float32, got "
                             f"{tuple(llrs.shape)} {llrs.dtype}")

    def decode(llrs):
        if not llrs.is_floating_point():
            return int8(llrs)
        check(llrs)
        if not kernel:
            return plain()(llrs)
        if "program" not in built:
            built["program"] = compile_program(code)
        with annotate("decode"):
            return decoder_kernel.decode_f32(
                built["program"], code.frozen,
                llrs.contiguous()).to(output_dtype)

    def lane_major(llr_t):
        if not llr_t.is_floating_point():
            return int8.lane_major(llr_t)
        check(llr_t)
        if kernel:
            raise ValueError("the float kernel reads frame-major (B, N) "
                             "LLRs: call decode(llrs)")
        return plain().lane_major(llr_t)

    decode.lane_major = lane_major
    return decode, "cuda-f32" if kernel else "eager"


def make_auto_decoder(code: PolarCode, *, output: str = "u",
                      output_dtype=torch.int8, device):
    """Best decoder for ``code`` on ``device``: returns ``(decode_fn,
    description)``. The LLRs' dtype picks the arithmetic: integer LLRs
    saturating int8, float ones min-sum. On a card the int8 decoder is
    :data:`AUTO_DECODERS`' for the output's track, by the batch of each
    call, and float32 LLRs take :func:`_by_dtype`'s route; the
    description names both ("...; float32 LLRs: cuda-f32")."""
    device = torch.device(device)
    if device.type != "cuda":
        return (make_fastssc_decoder(code, output=output,
                                     output_dtype=output_dtype), "eager")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    small, big = decoder_names(code.level, output != "u")
    if small == big:
        dec, desc = make_named_decoder(code, small, output, output_dtype)
    else:
        (dec_s, desc_s), (dec_b, desc_b) = (
            make_named_decoder(code, name, output, output_dtype)
            for name in (small, big))
        dec, desc = (_by_batch(dec_s, dec_b),
                     f"{desc_s} below {BIG_BATCH} frames, {desc_b} from it")
    dec, route = _by_dtype(dec, code, output, output_dtype)
    return dec, f"{desc}; float32 LLRs: {route}"
