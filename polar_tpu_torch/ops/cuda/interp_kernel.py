"""Interpreter Fast-SSC decoder on the card: the step program, the wrappers
and the plain version.

The kernel (``csrc/interp.cu`` over ``csrc/fastssc.cuh`` and ``mc.cuh``)
replaces the three kernels of ``polar_tpu/ops/pallas/interp_kernel.py``:

* :func:`make_interp_decoder` — ``make_interp_decoder`` (``:409``,
  ``_interp_kernel_entry`` ``:521`` → ``_interp_core`` ``:530``): a whole
  code decoded by a step program;
* :func:`make_interp_decode_count` — ``make_interp_decode_count``
  (``:569``): the same on the codeword-estimate track, then the five
  testbench counters;
* :func:`make_interp_subtree` — ``make_interp_subtree`` (``:687``,
  ``_interp_subtree_kernel`` ``:667``): one node of the hybrid decoder.

The program is this module's own numpy copy of the JAX package's
``_Program`` / ``_build_program`` (``:336-406``): a tree walk that emits
one int32 word per step, ``(pos >> kl) << 16 | branch``, over a table of
deduplicated branches. Above ``kl`` = ``min(subtree_level, level)`` the
branches are chain ops at one level (f, g, g0, comb, comb0, grate1); at or
below it, and for big rate-1 / rep / SPC leaves, a branch is a *body*: the
node decoded whole. The words and the number of branches equal the JAX
package's for every tree (``tests/test_torch_interp.py``). Each branch is
one int32 descriptor row (:data:`DESC_COLS`); a body's byte program
(``emit_program(node, node.level)``) and frozen mask (``node_frozen``)
lie in one flat uint8 table at the row's offsets. ``_CHAIN_CHUNK_ROWS``
is a fact about the TPU's vector registers: a thread walks a chain op's
rows one at a time, so the port has no chunks.

State, as the JAX kernel's: the soft pyramid (the input of a level-l node
at rows ``[2^l, 2^(l+1))``; the root's LLRs are read where they lie, so the
pyramid has N rows) and absolutely positioned hard, codeword and u
columns: the node at position p owns rows ``[p, p + 2^l)``. Rate-0 nodes
emit no step, so hard, cw and u start at +1 where the JAX kernel prefills
them (``:548-553``, ``:676-681``).

Every wrapper takes any batch, launches the kernel for CUDA tensors and
runs :func:`interp_plain` only for CPU tensors; :data:`launches` and
:data:`plain_calls` count what ran. The plain version walks the same words
and descriptors in torch, with the eager recursion as each body.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ...code.compiler import (Node, build_tree, compile_code, emit_program,
                              node_frozen)
from ...code.construction import PolarCode
from ...decode.fastssc import _TreeDecoder
from ...ops.arith import Int8Arith
from ...ops.transform import polar_transform
from . import build
from .decoder_kernel import THREADS
from .step_kernel import COUNTERS, cw_counts

LEAF_KINDS = ("rate0", "rate1", "rep", "spc")
# branch kinds, the descriptor's first column (csrc/interp.cu)
BODY, F, G, G0, COMB, COMB0, GRATE1 = range(7)
# descriptor columns: kind, level, safe, need_hard, cw, u, program offset,
# mask offset (the last two for bodies only, else -1)
DESC_COLS = 8
launches = {"interp_decoder": 0, "interp_decode_count": 0,
            "interp_subtree": 0}
plain_calls = {"interp_plain": 0}


@dataclass
class Program:
    """The step program of a tree: branches keyed as the JAX package keys
    them (first use gives the index), steps as ``(branch, pos)``."""

    branches: dict = field(default_factory=dict)   # key -> index
    steps: list = field(default_factory=list)      # (index, pos)
    ones_init: bool = False                        # a rate-0 node skipped?

    def step(self, key, pos: int) -> None:
        if key not in self.branches:
            self.branches[key] = len(self.branches)
        self.steps.append((self.branches[key], pos))

    def words(self, kl: int) -> np.ndarray:
        """One int32 word a step: 16-bit branch index, 15-bit position
        scaled by 2^kl."""
        if len(self.branches) >= 1 << 16:
            raise ValueError("branch table overflow (2^16 branches)")
        if any(pos >> kl >= 1 << 15 for _, pos in self.steps):
            raise ValueError("scaled position overflow: raise subtree_level")
        return np.asarray([(pos >> kl) << 16 | idx for idx, pos in self.steps],
                          np.int32)

    def keys(self) -> list:
        """Branch keys in index order."""
        return sorted(self.branches, key=self.branches.__getitem__)


def build_program(tree: Node, kl: int, want_cw: bool, want_u: bool,
                  root_need_hard: bool = False) -> Program:
    """The tree walk of ``polar_tpu/ops/pallas/interp_kernel.py:361``: the
    reference compiler's recursion with every node's position resolved,
    right-spine combines skipped when the root's hard is dead, and
    all-frozen nodes left to the +1 prefill."""
    prog = Program()

    def walk(node: Node, pos: int, safe: bool, need_hard: bool) -> None:
        if node.level <= kl or node.kind in LEAF_KINDS:
            if node.kind == "rate0":
                prog.ones_init = True
                return
            prog.step(("body", node, safe, need_hard, want_cw, want_u), pos)
            return
        lv, half = node.level, 1 << (node.level - 1)
        if node.kind == "branch":
            prog.step(("f", lv, safe), pos)
            walk(node.left, pos, True, True)
            prog.step(("g", lv, safe), pos)
            walk(node.right, pos + half, False, need_hard)
            if need_hard or want_cw:
                prog.step(("comb", lv, need_hard, want_cw), pos)
        elif node.kind == "rate0_right":
            prog.ones_init = True
            prog.step(("g0", lv), pos)
            walk(node.right, pos + half, False, need_hard)
            if need_hard or want_cw:
                prog.step(("comb0", lv, need_hard, want_cw), pos)
        elif node.kind == "rate1_comb":
            prog.step(("f", lv, safe), pos)
            walk(node.left, pos, True, True)
            prog.step(("grate1", lv, safe, need_hard, want_cw, want_u), pos)
        else:  # pragma: no cover
            raise AssertionError(node.kind)

    walk(tree, 0, safe=False, need_hard=root_need_hard)
    return prog


def info_positions(node: Node, pos: int = 0) -> list:
    """The node's info-bit positions, ascending: the order its message
    bits are emitted in (``interp_kernel.py:645``)."""
    s = 1 << node.level
    if node.kind == "rate0":
        return []
    if node.kind == "rate1":
        return list(range(pos, pos + s))
    if node.kind == "rep":
        return [pos + s - 1]
    if node.kind == "spc":
        return list(range(pos + 1, pos + s))
    half = s >> 1
    if node.kind == "rate0_right":
        return info_positions(node.right, pos + half)
    if node.kind == "rate1_comb":
        return info_positions(node.left, pos) + list(range(pos + half, pos + s))
    return (info_positions(node.left, pos)
            + info_positions(node.right, pos + half))


def tables(prog: Program):
    """``(desc (branches, DESC_COLS) int32, table uint8)``: each branch's
    descriptor, and the bodies' byte programs and masks, concatenated."""
    desc = np.zeros((len(prog.branches), DESC_COLS), np.int32)
    desc[:, 6:] = -1
    chunks, off = [], 0
    for i, key in enumerate(prog.keys()):
        kind = key[0]
        if kind == "body":
            _, node, safe, need_hard, cw, u = key
            program, mask = emit_program(node, node.level), node_frozen(node)
            desc[i] = (BODY, node.level, safe, need_hard, cw, u, off,
                       off + program.size)
            chunks += [program, mask]
            off += program.size + mask.size
        elif kind in ("f", "g"):
            desc[i, :3] = (F if kind == "f" else G, key[1], key[2])
        elif kind == "g0":
            desc[i, :2] = (G0, key[1])
        elif kind in ("comb", "comb0"):
            desc[i, :2] = (COMB if kind == "comb" else COMB0, key[1])
            desc[i, 3:5] = key[2:4]
        else:  # grate1
            desc[i, :6] = (GRATE1, *key[1:])
    table = (np.concatenate(chunks) if chunks else np.zeros(1, np.uint8))
    return desc, table.astype(np.uint8)


# -- the plain version -------------------------------------------------------


def interp_plain(words, desc, table, level: int, kl: int, llr_t, *,
                 want_cw: bool, want_u: bool, prefill: bool):
    """Walk ``words`` over the descriptor table in torch on element-major
    ``(2^level, B)`` int8 LLRs. Returns ``(hard, cw, u)`` ``(2^level, B)``
    int8 (cw, u None unless wanted): the state after the last step, u in
    the u domain (frozen rows +1)."""
    plain_calls["interp_plain"] += 1
    ph = Int8Arith()
    n = 1 << level
    words = np.asarray(words, np.int64)
    desc = np.asarray(desc)
    table = np.asarray(table, np.uint8)
    fill = torch.ones if prefill else torch.zeros
    hard = fill((n, llr_t.shape[1]), dtype=torch.int8, device=llr_t.device)
    cw = hard.clone() if want_cw else None
    u = hard.clone() if want_u else None
    pyr = torch.zeros_like(llr_t)  # rows [2^l, 2^(l+1)): a level-l input

    def slot(lv):
        return llr_t if lv == level else pyr[1 << lv:2 << lv]

    bodies = {}
    for w in words:
        kind, lv, _, need_hard, do_cw, do_u, p_off, m_off = (
            int(x) for x in desc[w & 0xFFFF])
        p = int(w >> 16) << kl
        s = slot(lv)
        if kind == BODY:
            ln = 1 << lv
            if (p_off, lv) not in bodies:
                mask = table[m_off:m_off + ln]
                program = table[p_off:m_off]
                node = build_tree(mask, lv)
                if not np.array_equal(emit_program(node, lv), program):
                    raise ValueError("a body's program was not emitted from "
                                     "its mask")
                bodies[p_off, lv] = (node, torch.as_tensor(
                    np.flatnonzero(mask == 0), device=llr_t.device))
            node, info = bodies[p_off, lv]
            dec = _TreeDecoder(ph, want_cw=bool(do_cw), axis=0)
            h_b, cw_b = dec.decode(node, s)
            if need_hard:
                hard[p:p + ln] = h_b
            if do_cw:
                cw[p:p + ln] = cw_b
            if do_u:
                u[p + info] = torch.cat(dec.mesg, dim=0)
            continue
        h = 1 << (lv - 1)
        a, b = s[:h], s[h:]
        if kind == F:
            pyr[h:2 * h] = ph.prod(a, b)
        elif kind == G:
            pyr[h:2 * h] = ph.madd(hard[p:p + h], a, b)
        elif kind == G0:
            pyr[h:2 * h] = ph.qadd(a, b)
        elif kind in (COMB, COMB0):
            for on, x in ((need_hard, hard), (do_cw, cw)):
                if on:
                    x[p:p + h] = (x[p + h:p + 2 * h] if kind == COMB0
                                  else x[p:p + h] * x[p + h:p + 2 * h])
        elif kind == GRATE1:
            hl = hard[p:p + h].clone()
            hr = ph.signum(ph.madd(hl, a, b))
            t = polar_transform(hr, axis=0)
            if do_u:
                u[p + h:p + 2 * h] = t
            if need_hard:
                hard[p:p + h] = hl * hr
                hard[p + h:p + 2 * h] = hr
            if do_cw:
                cwr = polar_transform(t, axis=0)
                cw[p:p + h] = cw[p:p + h] * cwr
                cw[p + h:p + 2 * h] = cwr
        else:  # pragma: no cover
            raise AssertionError(kind)
    return hard, cw, u


# -- the kernel --------------------------------------------------------------


@dataclass
class _Compiled:
    """A program ready to run: words, descriptors, table, its level and
    ``kl``, and the mask the u output is gathered by."""

    words: np.ndarray
    desc: np.ndarray
    table: np.ndarray
    level: int
    kl: int
    mask: np.ndarray
    ones_init: bool
    steps: int
    branches: int
    _dev: dict = field(default_factory=dict)

    def device_args(self, dev):
        """Device copies of words, descriptors, table and mask, once per
        device."""
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = tuple(torch.tensor(a, device=dev) for a in (
                self.words, self.desc.reshape(-1), self.table, self.mask))
        return self._dev[key]


def _compile(tree: Node, mask, subtree_level: int, want_cw: bool,
             want_u: bool, root_need_hard: bool = False) -> _Compiled:
    """The program of ``tree`` at ``min(subtree_level, tree.level)``."""
    kl = min(subtree_level, tree.level)
    prog = build_program(tree, kl, want_cw, want_u, root_need_hard)
    words = prog.words(kl)
    desc, table = tables(prog)
    return _Compiled(words, desc, table, tree.level, kl,
                     np.asarray(mask, np.uint8), prog.ones_init,
                     len(prog.steps), len(prog.branches))


def _check_llr(llr_t, n, what):
    if (llr_t.dtype != torch.int8 or llr_t.ndim != 2 or llr_t.shape[0] != n
            or not llr_t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous (N={n}, B) int8, got "
                         f"{tuple(llr_t.shape)} {llr_t.dtype}")


def _run(c: _Compiled, llr_t, *, want_cw: bool, want_u: bool, prefill: bool,
         entry: str, what: str):
    """Launch the decode kernel through C entry ``entry``: returns
    ``(hard, cw, u)``, u gathered into its first K rows by ``c.mask``."""
    dev = llr_t.device
    n, b = 1 << c.level, llr_t.shape[1]
    hard, cw, u = (torch.empty((n, b), dtype=torch.int8, device=dev)
                   if on else None for on in (True, want_cw, want_u))
    if b == 0:
        return hard, cw, u
    stream = build.stream(dev)
    pyr = torch.empty((n, b), dtype=torch.int8, device=dev)
    words, desc, table, mask = c.device_args(dev)
    err = getattr(build.load_library(), entry)(
        words.data_ptr(), c.steps, desc.data_ptr(), table.data_ptr(),
        mask.data_ptr(), c.level, c.kl, b, int(prefill), llr_t.data_ptr(),
        pyr.data_ptr(), hard.data_ptr(), cw.data_ptr() if want_cw else None,
        u.data_ptr() if want_u else None, THREADS, stream)
    build.check(err, entry)
    launches[what] += 1
    return hard, cw, u


def make_interp_decoder(code: PolarCode, tree: Node | None = None, *,
                        subtree_level: int = 10, output: str = "u",
                        output_dtype=torch.int8):
    """The interpreter whole-code decoder, with the eager decoder's
    contract: ``decode(llrs (B, N))`` → u ``(B, K)`` / systematic
    ``(B, K)`` / codeword ``(B, N)`` / both, and ``decode.lane_major(llr_t
    (N, B))`` with the code axis leading; ``decode.plain(llr_t)`` is the
    plain version of ``lane_major`` on any device. ``decode.program_steps``
    and ``decode.program_branches`` give the program's size.
    ``subtree_level``: nodes at or below it are bodies; ``output_dtype``
    casts the outputs. Any batch."""
    if tree is None:
        tree = compile_code(code)
    if output not in ("u", "systematic", "codeword", "both"):
        raise ValueError(f"unknown output mode {output!r}")
    want_cw = output != "u"
    want_u = output in ("u", "both")
    c = _compile(tree, code.frozen, subtree_level, want_cw, want_u)
    n, k = code.N, code.K
    prefill = c.ones_init or want_u

    def by_mode(u, cw):
        if output == "u":
            return u.to(output_dtype)
        if output == "systematic":
            info = torch.as_tensor(code.info_indices, device=cw.device)
            return cw[info].to(output_dtype)
        if output == "codeword":
            return cw.to(output_dtype)
        return u.to(output_dtype), cw.to(output_dtype)

    def plain(llr_t):
        _, cw, u = interp_plain(c.words, c.desc, c.table, c.level, c.kl,
                                llr_t, want_cw=want_cw, want_u=want_u,
                                prefill=prefill)
        info = torch.as_tensor(code.info_indices, device=llr_t.device)
        return by_mode(u[info] if want_u else None, cw)

    def lane_major(llr_t):
        _check_llr(llr_t, n, "interp decoder")
        if llr_t.device.type == "cpu":
            return plain(llr_t)
        if llr_t.device.type != "cuda":
            raise ValueError(f"no interp decoder for device {llr_t.device}")
        _, cw, u = _run(c, llr_t, want_cw=want_cw, want_u=want_u,
                        prefill=prefill, entry="polar_interp_decode",
                        what="interp_decoder")
        return by_mode(u[:k] if want_u else None, cw)

    def decode(llrs):
        if llrs.ndim != 2:
            raise ValueError("interp decoder expects (batch, N) LLRs")
        out = lane_major(llrs.t().contiguous())
        if isinstance(out, tuple):
            return tuple(o.t().contiguous() for o in out)
        return out.t().contiguous()

    decode.lane_major = lane_major
    decode.plain = plain
    decode.program_steps = c.steps
    decode.program_branches = c.branches
    return decode


def make_interp_decode_count(code: PolarCode, tree: Node | None = None, *,
                             subtree_level: int = 10):
    """``count(llr_t, cw_t)`` → the five counters (``(5,)`` int64, in
    ``step_kernel.COUNTERS`` order) of the interpreter decode on the
    codeword-estimate track against ``cw_t`` at the info rows, with the
    AWGN and quantization counters of ``llr_t``; both ``(N, B)`` int8.
    ``count.plain`` is its plain version on any device."""
    if tree is None:
        tree = compile_code(code)
    c = _compile(tree, code.frozen, subtree_level, True, False)
    n = code.N

    def plain(llr_t, cw_t):
        _, cw_hat, _ = interp_plain(c.words, c.desc, c.table, c.level, c.kl,
                                    llr_t, want_cw=True, want_u=False,
                                    prefill=c.ones_init)
        frz = torch.as_tensor(code.frozen.astype(bool),
                              device=llr_t.device).reshape(n, 1)
        return cw_counts(frz, llr_t, cw_t, cw_hat)

    def count(llr_t, cw_t):
        _check_llr(llr_t, n, "llr_t")
        _check_llr(cw_t, n, "cw_t")
        if cw_t.shape != llr_t.shape or cw_t.device != llr_t.device:
            raise ValueError("llr_t and cw_t must match in shape and device")
        dev, b = llr_t.device, llr_t.shape[1]
        if dev.type == "cpu":
            return plain(llr_t, cw_t)
        if dev.type != "cuda":
            raise ValueError(f"no interp decode+count for device {dev}")
        if b == 0:
            return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
        stream = build.stream(dev)
        out = torch.empty((-(-b // THREADS), len(COUNTERS)), dtype=torch.int32,
                          device=dev)
        pyr, hard, cw = (torch.empty((n, b), dtype=torch.int8, device=dev)
                         for _ in range(3))
        words, desc, table, mask = c.device_args(dev)
        err = build.load_library().polar_interp_decode_count(
            words.data_ptr(), c.steps, desc.data_ptr(), table.data_ptr(),
            mask.data_ptr(), c.level, c.kl, b, int(c.ones_init),
            llr_t.data_ptr(), cw_t.data_ptr(), pyr.data_ptr(),
            hard.data_ptr(), cw.data_ptr(), out.data_ptr(), THREADS, stream)
        build.check(err, "polar_interp_decode_count")
        launches["interp_decode_count"] += 1
        return out.sum(dim=0, dtype=torch.int64)

    count.plain = plain
    return count


def make_interp_subtree(node: Node, *, emit_u: bool = True,
                        emit_cw: bool = False, subtree_level: int = 10,
                        fuse: str | None = None):
    """The interpreter decoder of one hybrid node, with the contract of
    :func:`.subtree_kernel.make_subtree_decoder`: ``run(slot (2^l, B))`` →
    ``(u (k, B))?``, ``hard (2^l, B)``, ``(cw (2^l, B))?``, u at the node's
    :func:`info_positions`; ``run.plain`` is its plain version on any
    device. The root's hard is always kept (``root_need_hard``). No
    boundary fusion. Any batch."""
    if fuse is not None:
        raise ValueError("the interp kernel style has no boundary fusion")
    if node.mesg_bits < 1:
        raise ValueError("only nodes that emit message bits take a kernel")
    if not emit_u and not emit_cw:
        raise ValueError("emit_u=False needs emit_cw")
    c = _compile(node, node_frozen(node), subtree_level, emit_cw, emit_u,
                 root_need_hard=True)
    n, k = 1 << node.level, node.mesg_bits
    info = info_positions(node)

    def outs(hard, cw, u):
        return ((u,) if emit_u else ()) + (hard,) + ((cw,) if emit_cw else ())

    def plain(slot):
        hard, cw, u = interp_plain(c.words, c.desc, c.table, c.level, c.kl,
                                   slot, want_cw=emit_cw, want_u=emit_u,
                                   prefill=c.ones_init)
        return outs(hard, cw, u[torch.as_tensor(info, device=slot.device)]
                    if emit_u else None)

    def run(slot):
        _check_llr(slot, n, "interp subtree")
        if slot.device.type == "cpu":
            return plain(slot)
        if slot.device.type != "cuda":
            raise ValueError(f"no interp subtree decoder for device "
                             f"{slot.device}")
        hard, cw, u = _run(c, slot, want_cw=emit_cw, want_u=emit_u,
                           prefill=c.ones_init, entry="polar_interp_subtree",
                           what="interp_subtree")
        return outs(hard, cw, u[:k] if emit_u else None)

    run.plain = plain
    return run
