"""Fast-SSC decoder, eager PyTorch: the plain version of the CUDA decoder.

The port of ``polar_tpu.decode.fastssc`` without the hybrid subtree
kernels. The pruned-tree recursion runs in Python over the
:class:`~polar_tpu_torch.code.compiler.Node` tree, one batched tensor op
per node step; the frame batch rides along (the analog of the reference's
SIMD lane axis). Node semantics are op-for-op those of
``polar_decoder.hh``:

* f / "left"       (28-35):  prod of the two input halves
* g / "right"      (36-43):  madd with the left hard partial sums
* rate0_right      (44-51):  g with implicit +1 hard → saturating add
* comb             (52-59):  hard[i] *= hard_right[i]
* rate0            (68-75):  all +1, no message
* rate1            (85-93):  elementwise sign, message = transform(hard)
* rate1_comb       (76-84):  fused g + sign + comb + transform
* rep              (94-106): saturating fold-in-half adder tree, sign bcast
* spc             (107-127): Wagner decode — decide, parity, weakest |LLR|
                             flip (every tied minimum), message =
                             transform(hard)[1:]

The systematic and codeword outputs re-encode the u estimate
(``testbench.cc:177-183``); there is no root-hard shortcut, which would
differ whenever zero-LLR ties or SPC even-tie flips occur.
"""

from __future__ import annotations

import torch

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode
from ..ops.arith import FloatArith, Int8Arith, QuantFloatArith, arith_for
from ..ops.transform import polar_transform

OUTPUTS = ("u", "systematic", "codeword", "both")


class _TreeDecoder:
    """Recursion over the pruned tree along the code-element ``axis``:
    ``-1`` (frame-major ``(B, N)``) or ``0`` (element-major ``(N, B)``)."""

    def __init__(self, ph, axis: int = -1):
        if axis not in (0, -1):
            raise ValueError("axis must be 0 or -1")
        self.ph = ph
        self.axis = axis
        self.mesg: list = []

    def _sl(self, x, a, b):
        return x[a:b] if self.axis == 0 else x[..., a:b]

    def _halves(self, x):
        half = x.shape[self.axis] // 2
        return self._sl(x, None, half), self._sl(x, half, None)

    def _cat(self, parts):
        return torch.cat(parts, dim=self.axis)

    def _transform(self, x):
        return polar_transform(x, axis=self.axis)

    def _f(self, inp):
        lo, hi = self._halves(inp)
        return self.ph.prod(lo, hi)

    def _g(self, hard_left, inp):
        lo, hi = self._halves(inp)
        return self.ph.madd(hard_left, lo, hi)

    def _g_rate0(self, inp):
        # g with an all-(+1) left half: plain saturating add without the
        # -127 clamp, mirroring rate0_right (polar_decoder.hh:44-51)
        lo, hi = self._halves(inp)
        return self.ph.qadd(lo, hi)

    def _rep(self, soft):
        x = soft
        while x.shape[self.axis] > 1:
            lo, hi = self._halves(x)
            x = self.ph.qadd(lo, hi)
        bit = self.ph.signum(x)
        self.mesg.append(bit)
        return bit.expand(soft.shape)

    def _spc_hard(self, soft):
        ph = self.ph
        hard = ph.decide(soft)
        # torch.prod of int8 returns int64: narrow back
        parity = torch.prod(hard, dim=self.axis, keepdim=True).to(hard.dtype)
        sabs = ph.qabs(soft)
        weak = torch.amin(sabs, dim=self.axis, keepdim=True)
        return ph.flip(hard, parity, weak, sabs)

    def decode(self, node: Node, soft):
        """Returns this node's hard codeword estimate; message blocks are
        appended in emission order (in-order traversal)."""
        kind = node.kind
        ph = self.ph
        if kind == "rate0":
            return torch.ones_like(soft)
        if kind == "rate1":
            hard = ph.signum(soft)
            self.mesg.append(self._transform(hard))
            return hard
        if kind == "rep":
            return self._rep(soft)
        if kind == "spc":
            hard = self._spc_hard(soft)
            self.mesg.append(self._sl(self._transform(hard), 1, None))
            return hard
        if kind == "rate0_right":
            hard_r = self.decode(node.right, self._g_rate0(soft))
            return self._cat([hard_r, hard_r])
        hard_l = self.decode(node.left, self._f(soft))
        if kind == "rate1_comb":
            hard_r = ph.signum(self._g(hard_l, soft))
            self.mesg.append(self._transform(hard_r))
        elif kind == "branch":
            hard_r = self.decode(node.right, self._g(hard_l, soft))
        else:  # pragma: no cover
            raise AssertionError(kind)
        return self._cat([ph.qmul(hard_l, hard_r), hard_r])


def _resolve_arith(compute, dtype):
    if compute is None:
        return arith_for(dtype), None
    if isinstance(compute, str):
        modes = {
            "int8": (Int8Arith, torch.int8),
            "qfloat": (QuantFloatArith, torch.bfloat16),
            "qfloat-bf16": (QuantFloatArith, torch.bfloat16),
            "qfloat-f32": (QuantFloatArith, torch.float32),
            "float": (FloatArith, torch.float32),
            "float32": (FloatArith, torch.float32),
            "bfloat16": (FloatArith, torch.bfloat16),
        }
        if compute not in modes:
            raise ValueError(f"unknown compute mode {compute!r}")
        cls, work = modes[compute]
        return (cls() if cls is Int8Arith else cls(work)), work
    return compute, getattr(compute, "dtype", None)


def make_fastssc_decoder(
    code: PolarCode,
    tree: Node | None = None,
    *,
    output: str = "u",
    compute=None,
    output_dtype=None,
):
    """Build an eager Fast-SSC decoder for ``code``.

    ``output``:
      * ``"u"`` — (..., K) u-domain info bits (``polar_decoder.hh:131``);
      * ``"systematic"`` — (..., K) systematic message: the re-encoded
        codeword estimate gathered at info positions
        (``testbench.cc:177-183``);
      * ``"codeword"`` — (..., N) re-encoded codeword estimate;
      * ``"both"`` — tuple ``(u, codeword)``.

    ``compute``: None (infer from the input dtype: integer → saturating
    int8, float → plain min-sum), one of ``"int8"``, ``"qfloat"`` /
    ``"qfloat-bf16"``, ``"qfloat-f32"``, ``"float32"``, ``"bfloat16"``, or
    an arith object. ``output_dtype`` casts the hard outputs.

    The returned ``decode(llrs)`` takes frame-major ``(..., N)`` LLRs;
    ``decode.lane_major(llr_t)`` takes element-major ``(N, B)`` LLRs and
    returns outputs with the code axis leading (``u (K, B)``,
    ``cw (N, B)``).
    """
    if tree is None:
        tree = compile_code(code)
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    info_np = code.info_indices

    def run(x, axis):
        ph, work_dtype = _resolve_arith(compute, x.dtype)
        if work_dtype is not None:
            x = x.to(work_dtype)
        dec = _TreeDecoder(ph, axis=axis)
        dec.decode(tree, x)
        u = torch.cat(dec.mesg, dim=axis)
        out_dtype = output_dtype or u.dtype
        info = torch.as_tensor(info_np, dtype=torch.long, device=x.device)
        if output == "u":
            return u.to(out_dtype)
        # re-encode: scatter u into the +1-filled u-domain block, transform
        shape = list(u.shape)
        shape[axis] = code.N
        full = torch.ones(shape, dtype=u.dtype, device=u.device)
        if axis == 0:
            full[info] = u
        else:
            full[..., info] = u
        cw = polar_transform(full, axis=axis)
        if output == "systematic":
            return (cw[info] if axis == 0 else cw[..., info]).to(out_dtype)
        if output == "codeword":
            return cw.to(out_dtype)
        return u.to(out_dtype), cw.to(out_dtype)

    def decode(llrs):
        return run(llrs, -1)

    def decode_lane_major(llr_t):
        """Element-major entry: LLRs ``(N, B)`` → outputs with the code
        axis leading (the CUDA kernels' layout)."""
        if llr_t.ndim != 2 or llr_t.shape[0] != code.N:
            raise ValueError(f"expected (N={code.N}, B) lane-major LLRs")
        return run(llr_t, 0)

    decode.lane_major = decode_lane_major
    return decode

