"""Fast-SSC decoder, eager PyTorch: the plain version of the CUDA decoder,
and the hybrid large-N decoder.

The port of ``polar_tpu.decode.fastssc``. The pruned-tree recursion runs
in Python over the
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
differ whenever zero-LLR ties or SPC even-tie flips occur. The hybrid
(``kernel_level``) hands the subtrees below a level to the subtree decoder
and combines their codeword-estimate blocks up the tree, which equals the
re-encode by construction.
"""

from __future__ import annotations

import torch

from ..code.compiler import Node, compile_code, emit_program
from ..code.construction import PolarCode
from ..ops.arith import FloatArith, Int8Arith, QuantFloatArith, arith_for
from ..ops.transform import polar_transform
from ..utils.profiling import annotate

OUTPUTS = ("u", "systematic", "codeword", "both")
KERNEL_STYLES = ("ssa", "walk", "scratch", "interp")


class _TreeDecoder:
    """Recursion over the pruned tree along the code-element ``axis``:
    ``-1`` (frame-major ``(B, N)``) or ``0`` (element-major ``(N, B)``).

    ``subtree_kernel_for``: optional ``(node, fuse=None) -> fn or None``
    that hands composite subtrees to the subtree decoder
    (:mod:`polar_tpu_torch.ops.cuda.subtree_kernel`): the hybrid decoder,
    eager torch for the upper levels. ``want_cw`` carries the re-encoded
    codeword-estimate track through the recursion (each node's
    ``encode`` of its u segment, frozen rows +1, combined as
    ``[cw_l·cw_r, cw_r]``). ``kernel_emits_u``: whether the subtree
    decoders return a leading u block. The routing is
    ``polar_tpu/decode/fastssc.py:140-240``'s, so the message blocks come
    in the same order."""

    _KERNEL_KINDS = ("branch", "rate0_right", "rate1_comb")

    def __init__(self, ph, subtree_kernel_for=None, want_cw: bool = False,
                 axis: int = -1, kernel_emits_u: bool = True):
        if axis not in (0, -1):
            raise ValueError("axis must be 0 or -1")
        self.ph = ph
        self.subtree_kernel_for = subtree_kernel_for
        self.want_cw = want_cw
        self.kernel_emits_u = kernel_emits_u
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
        """Returns ``(hard, cw)``: this node's hard codeword estimate and,
        with ``want_cw``, its codeword-estimate block (else None). Message
        blocks are appended in emission order (in-order traversal)."""
        kind = node.kind
        ph = self.ph
        cw = self.want_cw
        if self.subtree_kernel_for is not None and kind in self._KERNEL_KINDS:
            kernel = self.subtree_kernel_for(node)
            if kernel is not None:
                return self._kernel_outs(kernel(soft.contiguous()))
        if kind == "rate0":
            ones = torch.ones_like(soft)
            return ones, (ones if cw else None)
        if kind == "rate1":
            hard = ph.signum(soft)
            t = self._transform(hard)
            self.mesg.append(t)
            return hard, (self._transform(t) if cw else None)
        if kind == "rep":
            hard = self._rep(soft)
            # u segment [+1, ..., +1, bit] encodes to bit everywhere
            return hard, (hard if cw else None)
        if kind == "spc":
            hard = self._spc_hard(soft)
            v = self._transform(hard)
            self.mesg.append(self._sl(v, 1, None))
            cw_v = None
            if cw:  # u segment [+1 (frozen), v_1 .. v_{L-1}]
                cw_v = self._transform(self._cat(
                    [torch.ones_like(self._sl(v, None, 1)), self._sl(v, 1, None)]))
            return hard, cw_v
        if kind == "rate0_right":
            hard_r, cw_r = self.decode(node.right, self._g_rate0(soft))
            return (self._cat([hard_r, hard_r]),
                    self._cat([cw_r, cw_r]) if cw else None)
        if kind == "rate1_comb":
            hard_l, cw_l = self._decode_left(node, soft)
            hard_r = ph.signum(self._g(hard_l, soft))
            t = self._transform(hard_r)
            self.mesg.append(t)
            cw_v = None
            if cw:
                cw_r = self._transform(t)
                cw_v = self._cat([cw_l * cw_r, cw_r])
            return self._cat([ph.qmul(hard_l, hard_r), hard_r]), cw_v
        if kind == "branch":
            hard_l, cw_l = self._decode_left(node, soft)
            fused = self._decode_right_fused(node, soft, hard_l, cw_l)
            if fused is not None:
                return fused
            hard_r, cw_r = self.decode(node.right, self._g(hard_l, soft))
            return (self._cat([ph.qmul(hard_l, hard_r), hard_r]),
                    self._cat([cw_l * cw_r, cw_r]) if cw else None)
        raise AssertionError(kind)  # pragma: no cover

    def _kernel_outs(self, outs):
        base = 0
        if self.kernel_emits_u:
            self.mesg.append(outs[0])
            base = 1
        return outs[base], (outs[base + 1] if self.want_cw else None)

    def _decode_left(self, node: Node, soft):
        """The left child of a branch / rate1_comb node: with boundary
        fusion, a kernel-eligible child takes the parent's slot and runs
        the parent's f itself; otherwise f here feeds the recursion."""
        if (self.subtree_kernel_for is not None
                and node.left.kind in self._KERNEL_KINDS):
            kernel = self.subtree_kernel_for(node.left, fuse="f")
            if kernel is not None:
                return self._kernel_outs(kernel(soft.contiguous()))
        return self.decode(node.left, self._f(soft))

    def _decode_right_fused(self, node: Node, soft, hard_l, cw_l):
        """The right child of a branch node with the parent's g and
        combine fused into its kernel: returns the parent's combined
        ``(hard, cw)``, or None when the child takes no fused kernel."""
        if (self.subtree_kernel_for is None
                or node.right.kind not in self._KERNEL_KINDS):
            return None
        kernel = self.subtree_kernel_for(node.right, fuse="g")
        if kernel is None:
            return None
        args = (soft, hard_l) + ((cw_l,) if self.want_cw else ())
        return self._kernel_outs(kernel(*(a.contiguous() for a in args)))


def frame_major(lane_major, what: str):
    """The frame-major entry ``decode(llrs (B, N))`` of an element-major
    decoder ``lane_major(llr_t (N, B))``: a transpose in, the decode and a
    transpose out of each output, under the spans ``decode``,
    ``decode.transpose_in`` and ``decode.transpose_out``."""

    def decode(llrs):
        if llrs.ndim != 2:
            raise ValueError(f"{what} expects (batch, N) LLRs")
        with annotate("decode"):
            with annotate("decode.transpose_in"):
                llr_t = llrs.t().contiguous()
            out = lane_major(llr_t)
            with annotate("decode.transpose_out"):
                if isinstance(out, tuple):
                    return tuple(o.t().contiguous() for o in out)
                return out.t().contiguous()

    return decode


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


def make_kernel_for(kernel_level: int, *, style: str = "ssa",
                    boundary_fusion: bool = False, emit_u: bool = True,
                    emit_cw: bool = False):
    """The hybrid's router to the subtree kernels, for
    :class:`_TreeDecoder`'s ``subtree_kernel_for``: ``kernel_for(node,
    fuse=None)`` returns the subtree decoder of a composite node at or
    below ``kernel_level`` that emits message bits (the CUDA kernel of
    ``style`` for CUDA blocks, its plain version for CPU ones), else None.
    One decoder per distinct node pattern, keyed by ``emit_program(node,
    node.level)`` and the fuse mode; ``boundary_fusion`` allows the fused
    modes (SSA and walk styles only). ``emit_u`` / ``emit_cw``: the blocks the
    kernels return beside the node's hard block."""
    from ..ops.cuda.interp_kernel import make_interp_subtree
    from ..ops.cuda.subtree_kernel import make_subtree_decoder

    cache: dict = {}

    def kernel_for(node: Node, fuse: str | None = None):
        if node.level > kernel_level or node.mesg_bits < 1:
            return None
        if fuse and not (boundary_fusion and style in ("ssa", "walk")):
            return None
        key = (emit_program(node, node.level).tobytes(), fuse)
        if key not in cache:
            if style == "interp":
                cache[key] = make_interp_subtree(node, emit_u=emit_u,
                                                 emit_cw=emit_cw)
            else:
                cache[key] = make_subtree_decoder(
                    node, emit_u=emit_u, emit_cw=emit_cw, fuse=fuse,
                    style=style)
        return cache[key]

    return kernel_for


def make_fastssc_decoder(
    code: PolarCode,
    tree: Node | None = None,
    *,
    output: str = "u",
    compute=None,
    output_dtype=None,
    kernel_level: int | None = None,
    kernel_style: str = "ssa",
    kernel_fuse: bool = False,
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

    ``kernel_level``: the hybrid decoder (``polar_tpu/decode/fastssc.py``'s
    ``kernel_level`` path). Composite nodes at or below this level that
    emit message bits go to the subtree decoder
    (:mod:`polar_tpu_torch.ops.cuda.subtree_kernel`: the CUDA kernel for
    CUDA tensors, its plain version for CPU ones); the levels above run
    eagerly. One decoder per distinct node pattern, keyed by
    ``emit_program(node, node.level)`` and the fuse mode. The hybrid takes
    int8 arithmetic only, any batch (the kernels mask their last block),
    and 2-D inputs. With a non-u output the codeword estimate comes from
    the subtrees' cw blocks combined up the tree (the fused cw track);
    ``"systematic"`` and ``"codeword"`` then skip the subtrees' u blocks.
    ``kernel_fuse``: boundary fusion — a kernel-eligible left child runs
    its parent's f, a kernel-eligible right child of a branch its
    parent's g and combine (the SSA and walk styles only; ``"interp"`` raises,
    the scratch style ignores it, as in JAX). ``kernel_style`` picks the
    subtree kernel (``polar_tpu/decode/fastssc.py:328-394``): ``"ssa"``
    (:mod:`~polar_tpu_torch.ops.cuda.subtree_kernel`: the tile kernel up to
    its ``TILE_SUBTREE_MAX_LEVEL``, the walk above), ``"walk"`` (the
    one-thread-a-frame walk at every level, for the A/B), ``"scratch"`` (its
    shared-memory twin: u blocks only, so non-u outputs re-encode û, and
    nodes at most ``decoder_kernel.SCRATCH_MAX_LEVEL``) or ``"interp"``
    (:func:`~polar_tpu_torch.ops.cuda.interp_kernel.make_interp_subtree`
    at its default ``subtree_level``, with the fused cw track). All are
    bit-exact.

    The returned ``decode(llrs)`` takes frame-major ``(..., N)`` LLRs;
    ``decode.lane_major(llr_t)`` takes element-major ``(N, B)`` LLRs and
    returns outputs with the code axis leading (``u (K, B)``,
    ``cw (N, B)``). The hybrid always runs element-major: its frame-major
    entry transposes in and out.
    """
    if tree is None:
        tree = compile_code(code)
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    if kernel_style not in KERNEL_STYLES:
        raise ValueError(f"unknown kernel style {kernel_style!r}")
    if kernel_style == "interp" and kernel_fuse:
        raise ValueError("the interp kernel style has no boundary fusion")
    info_np = code.info_indices
    hybrid = kernel_level is not None
    # fused cw track: non-u hybrid outputs combine the subtrees' cw blocks
    # instead of re-encoding the whole u (the scratch style has no cw
    # block); "systematic" / "codeword" then never read the u blocks, so
    # the subtrees skip them
    use_fused_cw = (hybrid and output != "u"
                    and kernel_style != "scratch")
    kernel_emit_u = not use_fused_cw or output == "both"
    kernel_for = (make_kernel_for(kernel_level, style=kernel_style,
                                  boundary_fusion=kernel_fuse,
                                  emit_u=kernel_emit_u, emit_cw=use_fused_cw)
                  if hybrid else None)

    def run(x, axis):
        ph, work_dtype = _resolve_arith(compute, x.dtype)
        if hybrid and not isinstance(ph, Int8Arith):
            raise ValueError("the hybrid decoder takes int8 arithmetic only")
        if work_dtype is not None:
            x = x.to(work_dtype)
        dec = _TreeDecoder(ph, kernel_for, want_cw=use_fused_cw, axis=axis,
                           kernel_emits_u=kernel_emit_u)
        _, cw = dec.decode(tree, x)
        # without subtree u blocks, dec.mesg holds only the (dead) blocks of
        # eager leaves, so no u is assembled
        u = torch.cat(dec.mesg, dim=axis) if kernel_emit_u else None
        out_dtype = output_dtype or (u if u is not None else cw).dtype
        if output == "u":
            return u.to(out_dtype)
        if cw is None:
            # re-encode: scatter u into the +1-filled u-domain block,
            # transform
            info = torch.as_tensor(info_np, dtype=torch.long, device=x.device)
            shape = list(u.shape)
            shape[axis] = code.N
            full = torch.ones(shape, dtype=u.dtype, device=u.device)
            if axis == 0:
                full[info] = u
            else:
                full[..., info] = u
            cw = polar_transform(full, axis=axis)
        if output == "systematic":
            info = torch.as_tensor(info_np, dtype=torch.long, device=cw.device)
            return (cw[info] if axis == 0 else cw[..., info]).to(out_dtype)
        if output == "codeword":
            return cw.to(out_dtype)
        return u.to(out_dtype), cw.to(out_dtype)

    def decode_lane_major(llr_t):
        """Element-major entry: LLRs ``(N, B)`` → outputs with the code
        axis leading (the CUDA kernels' layout)."""
        if llr_t.ndim != 2 or llr_t.shape[0] != code.N:
            raise ValueError(f"expected (N={code.N}, B) lane-major LLRs")
        return run(llr_t, 0)

    if hybrid:
        decode = frame_major(decode_lane_major, "hybrid decoder")
    else:
        def decode(llrs):
            return run(llrs, -1)

    decode.lane_major = decode_lane_major
    return decode
