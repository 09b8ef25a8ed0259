"""Decoder selection by device and code size.

* CUDA — the hand-written whole-code Fast-SSC kernel
  (:mod:`polar_tpu_torch.ops.cuda.decoder_kernel`), one launch per call,
  for every output mode; from ``HYBRID_MIN_LEVEL`` up, the hybrid decoder
  (eager top levels, subtree kernels at and below ``HYBRID_KERNEL_LEVEL``)
  where the H100 timings in PERF.md put it ahead, for the frame-major
  decoders built here and for the front path's lane-major ones alike;
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


def hybrid_kernel_level(level: int) -> int:
    """The hybrid's kernel level for a code of this level: the measured
    ``HYBRID_KERNEL_LEVEL``, cut to ``level - 1`` for smaller codes."""
    return min(HYBRID_KERNEL_LEVEL, level - 1)


def make_kernel_decoder(code: PolarCode, *, output: str = "u",
                        output_dtype=torch.int8):
    """The CUDA kernel decoder with the eager decoder's interface:
    ``decode(llrs)`` on frame-major ``(B, N)`` int8 LLRs and
    ``decode.lane_major(llr_t)`` on element-major ``(N, B)`` ones (no
    transposes). The kernel always runs element-major; the frame-major
    entry transposes in and out."""
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    program = compile_program(code)
    frozen = code.frozen
    want_cw = output != "u"

    def lane_major(llr_t):
        mesg, cw = decoder_kernel.decode(program, frozen, llr_t, want_cw)
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


def make_auto_decoder(code: PolarCode, *, output: str = "u",
                      output_dtype=torch.int8, device):
    """Best decoder for ``code`` on ``device``: returns ``(decode_fn,
    description)``. Inputs are int8 LLRs."""
    device = torch.device(device)
    if device.type == "cuda" and code.level >= HYBRID_MIN_LEVEL:
        kl = hybrid_kernel_level(code.level)
        return (make_fastssc_decoder(code, output=output,
                                     output_dtype=output_dtype,
                                     kernel_level=kl), f"cuda-hybrid-kl{kl}")
    if device.type == "cuda":
        return (make_kernel_decoder(code, output=output,
                                    output_dtype=output_dtype), "cuda-fastssc")
    return (make_fastssc_decoder(code, output=output, output_dtype=output_dtype),
            "eager")
