"""Decoder selection by device.

* CUDA — the hand-written Fast-SSC kernel
  (:mod:`polar_tpu_torch.ops.cuda.decoder_kernel`), one launch per call,
  for every output mode;
* CPU — the eager decoder (:func:`~polar_tpu_torch.decode.fastssc.make_fastssc_decoder`).

Both are bit-exact with each other and with ``polar_tpu``; the choice is
the device's. The JAX package's per-level tile and VMEM tables are facts
about the TPU and do not carry over.
"""

from __future__ import annotations

import torch

from ..code.compiler import compile_program
from ..code.construction import PolarCode
from ..ops.cuda import decoder_kernel
from .fastssc import OUTPUTS, make_fastssc_decoder


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
    if device.type == "cuda":
        return (make_kernel_decoder(code, output=output,
                                    output_dtype=output_dtype), "cuda-fastssc")
    return (make_fastssc_decoder(code, output=output, output_dtype=output_dtype),
            "eager")
