"""Naive successive-cancellation decoder (correctness anchor), eager torch.

The port of ``polar_tpu.decode.sc``: textbook SC over the full code tree
with min-sum f, g and per-leaf sign decisions, no special-node pruning.
The recursion runs in Python over static shapes, one batched tensor op per
tree step; the batch dimension carries the frames, on any device. The
arithmetic is :mod:`polar_tpu_torch.ops.arith`'s, dispatched on the input
dtype (integer → saturating int8, float → plain min-sum), so int8 decodes
are bit-exact with the JAX package's. There is no kernel: the JAX package
has none either. This is the decoder a caller pins to check Fast-SSC
(whose pruning is decision-equivalent, Sarkis et al. 2013).
"""

from __future__ import annotations

import numpy as np
import torch

from ..code.construction import PolarCode
from ..encode import encode
from ..ops import arith
from .fastssc import OUTPUTS


def _f(inp):
    half = inp.shape[-1] // 2
    return arith.prod(inp[..., :half], inp[..., half:])


def _g(hard_left, inp):
    half = inp.shape[-1] // 2
    return arith.madd(hard_left, inp[..., :half], inp[..., half:])


def _decode_node(soft, frozen: np.ndarray, mesg: list) -> torch.Tensor:
    """Returns the node's hard codeword estimate; appends message blocks."""
    n = soft.shape[-1]
    if n == 1:
        if frozen[0]:
            return torch.ones_like(soft)
        hard = arith.signum(soft)
        mesg.append(hard)
        return hard
    half = n // 2
    hard_l = _decode_node(_f(soft), frozen[:half], mesg)
    hard_r = _decode_node(_g(hard_l, soft), frozen[half:], mesg)
    return torch.cat([arith.qmul(hard_l, hard_r), hard_r], dim=-1)


def make_sc_decoder(code: PolarCode, *, output: str = "u"):
    """Build a decoder: LLRs (..., N) → u-domain info bits (..., K).

    ``output`` mirrors :func:`polar_tpu_torch.decode.fastssc.make_fastssc_decoder`:
    ``"u"``, ``"systematic"``, ``"codeword"``, or ``"both"`` (u, codeword).
    """
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    frozen = np.asarray(code.frozen, dtype=np.uint8)

    def decode(llrs):
        mesg: list = []
        _decode_node(llrs, frozen, mesg)
        u = torch.cat(mesg, dim=-1)
        if output == "u":
            return u
        cw = encode(code, u)
        if output == "systematic":
            return cw[..., torch.as_tensor(code.info_indices,
                                           device=cw.device)]
        if output == "codeword":
            return cw
        return u, cw

    return decode
