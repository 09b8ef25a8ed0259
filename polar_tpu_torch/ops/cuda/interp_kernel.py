"""Interpreter Fast-SSC decoder on the card: the step program, its
schedule, the wrappers and the plain version.

The kernels (``csrc/interp.cu``) replace the three kernels of
``polar_tpu/ops/pallas/interp_kernel.py``:

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
lie in one flat uint8 table at the row's offsets.

State, as the JAX kernel's: the soft pyramid (the input of a level-l node
at rows ``[2^l, 2^(l+1))``; the root's LLRs are read where they lie) and
absolutely positioned hard, codeword and u columns: the node at position
p owns rows ``[p, p + 2^l)``. Rate-0 nodes emit no step, so hard, cw and
u start at +1 where the JAX kernel prefills them (``:548-553``,
``:676-681``).

One kernel, ``interp_tile_kernel``, runs the program as :func:`schedule` cuts it at the grid level
:data:`INTERP_GRID_LEVEL`: grid entries (the words at or above it, over
rows × 16-frame chunks of the whole batch, a grid barrier between
dependent entries) and tile runs (each subtree below it, one warp's tile
of :data:`TILE_FRAMES` frames at a time, on the tile core of
``csrc/fastssc_simd.cuh``); its message is written compacted, so u needs
no gather. The whole-code decoder's u track also runs frame-major on a
card: the kernel reads ``(B, N)`` LLRs and writes u ``(B, K)`` (a u-only
schedule reads the root only as an entry's rows a and b and never reads
u, so it serves either layout).

Every wrapper takes any batch, launches the kernel for CUDA tensors and
runs :func:`interp_plain` only for CPU tensors; :data:`launches` and
:data:`plain_calls` count what ran. The plain version walks the same words
and descriptors in torch, with the eager recursion as each body.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ...code.compiler import (Node, build_tree, compile_code, emit_program,
                              node_frozen)
from ...code.construction import PolarCode
from ...decode.fastssc import _TreeDecoder, frame_major
from ...ops.arith import Int8Arith
from ...ops.transform import polar_transform
from ...utils import profiling
from . import build, count_kernel, tile_stages
from .step_kernel import COUNTERS, cw_counts

LEAF_KINDS = ("rate0", "rate1", "rep", "spc")
# branch kinds, the descriptor's first column (csrc/interp.cu)
BODY, F, G, G0, COMB, COMB0, GRATE1 = range(7)
# descriptor columns: kind, level, safe, need_hard, cw, u, program offset,
# mask offset (the last two for bodies only, else -1)
DESC_COLS = 8


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


# -- the schedule: grid steps and tile runs ---------------------------------

# The grid level G: words at or above it are grid steps, the rest tile
# runs. It is at least kl + 1, so that every body that is not a leaf lies
# in a tile run (a body is decoded by one warp's tile, all its rows on
# chip); at B = 4096 one level-11 op is 2^10 rows x 256 chunks of 16
# frames, enough items to fill the card.
INTERP_GRID_LEVEL = 11
TILE_FRAMES = 8        # csrc/interp.cu: Tile<2, 2>, 8 frames a warp
TILE_WR = TILE_VW = 2
TILE_MAX_WARPS = 4     # warps (tiles) a block
CHUNK_FRAMES = 16      # a grid item: one row of 16 frames, 16 bytes
SMEM_BYTES = 232448    # the shared memory an H100 block may take
# the frame-major u track (csrc/interp.cu): a warp stages the root through
# 512 bytes of shared memory, 16 bytes of a frame a lane, so the root is on
# 16 bytes and its grid entries take 32 rows a half (level 6 and up)
STAGE_BYTES = 512
FRAMES_GRID_LEVEL = 6
# schedule entry kinds, column 0 (csrc/interp.cu); CHAIN: the next entry
# runs without a grid barrier before it (it reads nothing this one writes)
(RUN, S_F, S_G, S_ADD, S_HMUL, S_COPY, S_GRATE1, S_STAGE, S_RATE1, S_KEY,
 S_KEYRED, S_FLIP, S_REPBC, S_FILL) = range(14)
CHAIN = 0x100
# columns: kind, rows, then the rows a, b, c, d, e and a stage x; a row is
# (array << ROW_BITS) | row of the arrays IN (the root LLRs), PYR (the
# soft pyramid, N + 1 rows: row N holds an SPC's reduction), HARD, CW and
# U (the message, compacted: K rows), -1 for none
SCHED_COLS = 8
ROW_BITS = 20
IN, PYR, HARD, CW, U = range(5)


def _row(array: int, row: int) -> int:
    return array << ROW_BITS | row


@dataclass
class Schedule:
    """A program cut into grid entries and tile runs for the tile kernel.

    ``entries`` (E, SCHED_COLS) int32, in order; ``mrows`` (steps,) int32,
    each body's (grate1's) first compacted message row; ``grid_level`` the
    G in force; ``region_level`` the largest tile run's root level (a
    warp's shared regions hold 2^region_level rows each); ``runs`` the tile
    runs, ``grid_steps`` the words at or above G, ``barriers`` the grid
    barriers, ``max_rows`` the most rows (pairs) of any grid entry,
    ``origin`` the word each entry comes from (-1: a prefill)."""

    entries: np.ndarray
    mrows: np.ndarray
    grid_level: int
    region_level: int
    runs: list
    grid_steps: list
    barriers: int
    max_rows: int
    origin: np.ndarray    # (E,) the word of each entry (-1: a prefill)

    @property
    def cooperative(self) -> bool:
        """Whether any grid step needs a grid barrier (else one launch
        over the tiles, no barrier)."""
        return bool(self.grid_steps)


def _transform(out: list, src: int, dst: int, rows: int,
               to: int | None = None) -> None:
    """Entries of the polar transform of ``rows`` rows from ``src`` into
    ``dst`` (in place when equal): one butterfly stage each; with ``to``
    the last stage (a copy of one row) writes ``to`` in place of ``dst``."""
    stages = rows.bit_length() - 1
    end = dst if to is None else to
    if stages == 0 and src != end:
        out.append([S_COPY, 1, src, -1, -1, end, -1, 0])
    for s in range(stages):
        out.append([S_STAGE, rows // 2, src if s == 0 else dst, -1, -1,
                    end if s == stages - 1 else dst, -1, s])


def _leaf_entries(kind: str, lv: int, p: int, mrow: int, level: int,
                  need_hard: bool, do_cw: bool, do_u: bool) -> list:
    """Grid entries of a leaf body at or above G: the node's rows × chunks
    in passes, its reductions by halving, its transforms by stages (u
    alone: by the last stage, so that no entry reads u)."""
    n = 1 << lv
    s = _row(IN, 0) if lv == level else _row(PYR, n)
    hard = _row(HARD, p) if need_hard else -1
    cw, u = _row(CW, p), _row(U, mrow)
    out = []
    if kind == "rate1" and do_u and not do_cw:  # in the free rows below
        t = _row(PYR, 0)
        out.append([S_RATE1, n, s, -1, hard, t, -1, 0])
        _transform(out, t, t, n, to=u)
    elif kind == "rate1":     # u = T(signum(x)), cw = T(u)
        t = u if do_u else cw
        out.append([S_RATE1, n, s, -1, hard, t, -1, 0])
        _transform(out, t, t, n)
        if do_cw:
            _transform(out, t, cw, n)
    elif kind == "rep":       # saturating fold in halves, then the bit
        src, h = s, n // 2
        while h >= 1:
            out.append([S_ADD, h, src, src + h, -1, _row(PYR, 0), -1, 0])
            src, h = _row(PYR, 0), h // 2
        out.append([S_REPBC, n, -1, _row(PYR, 0), hard, cw if do_cw else -1,
                    u if do_u else -1, 0])
    elif kind == "spc":       # parity and weakest |x| into row N, flip
        key, src, h = _row(PYR, 1 << level), s, n // 2
        while h >= 1:
            out.append([S_KEY if src == s else S_KEYRED, h, src, src + h, -1,
                        key if h == 1 else _row(PYR, 0), -1, 0])
            src, h = _row(PYR, 0), h // 2
        t = cw if do_cw else _row(PYR, 0)
        out.append([S_FLIP, n, s, key, hard, t, -1, 0])
        _transform(out, t, t, n)           # T(h): the message at rows 1..
        if do_u:
            out.append([S_COPY | (CHAIN if do_cw else 0), n - 1, t + 1, -1,
                        -1, u, -1, 0])
        if do_cw:                          # cw = T([+1, T(h)[1:]])
            out.append([S_FILL, 1, -1, -1, -1, t, -1, 0])
            _transform(out, t, t, n)
    else:  # pragma: no cover
        raise AssertionError(kind)
    return out


def schedule(words, desc, table, level: int, kl: int, mask, *,
             grid_level: int, want_cw: bool, want_u: bool,
             prefill: bool) -> Schedule:
    """Cut a program into the tile kernel's order (``csrc/interp.cu``).

    Words at or above ``G = max(grid_level, kl + 1)`` are grid steps: a
    chain op is one pass over its rows × 16-frame chunks; a grate1 or a
    leaf body there is a few passes (its transforms by stages, REP's and
    SPC's per-frame reductions by halving). Every maximal run of words
    below G (one subtree, since the walk is depth-first) is a tile run: a
    warp runs it on its tile of frames, state on chip, its root slot read
    in device memory. With ``prefill`` the rows of hard and cw that no tile
    run writes back start at +1. On the u track alone no entry reads u,
    the root is read only as an entry's rows a and b, and u written only
    as its rows d and e (grate1s and rate-1 leaves transform in the
    pyramid's free rows ``[0, 2^l)`` below their slot, the last stage into
    u), so the kernel may hold the root and u either way round. Raises
    ``ValueError`` where a tile run's regions exceed a block's shared
    memory."""
    words = np.asarray(words, np.int64)
    desc = np.asarray(desc)
    n = 1 << level
    info = np.flatnonzero(np.asarray(mask) == 0)
    g = max(grid_level, kl + 1)
    kinds, lvs = desc[words & 0xFFFF, 0], desc[words & 0xFFFF, 1]
    pos = (words >> 16) << kl
    # a body's message starts at its position, a grate1's at its right half
    first = pos + np.where(kinds == GRATE1, 1 << (lvs - 1), 0)
    mrows = np.where((kinds == BODY) | (kinds == GRATE1),
                     np.searchsorted(info, first), 0).astype(np.int32)
    entries, runs, grid_steps, covered = [], [], [], []
    origin = []        # the word each entry comes from
    i = 0
    while i < len(words):
        if lvs[i] < g:
            j = i
            while j < len(words) and lvs[j] < g:
                j += 1
            r, p0 = int(lvs[i]), int(pos[i])
            inside = (lvs[i:j] <= r) & (pos[i:j] >= p0) & (
                pos[i:j] < p0 + (1 << r))
            if not inside.all():  # pragma: no cover
                raise AssertionError("a tile run is not one subtree")
            entries.append([RUN, 0, i, j, r, p0, 0, 0])
            origin.append(i)
            runs.append((i, j, r, p0))
            covered.append((p0, p0 + (1 << r)))
            i = j
            continue
        grid_steps.append(i)
        before = len(entries)
        kind, lv, _, need_hard, do_cw, do_u = (int(x) for x in
                                               desc[words[i] & 0xFFFF][:6])
        p, h = int(pos[i]), 1 << (lv - 1)
        s = _row(IN, 0) if lv == level else _row(PYR, 1 << lv)
        child = _row(PYR, h)
        if kind == BODY:
            m_off = int(desc[words[i] & 0xFFFF][7])
            node = build_tree(np.asarray(table)[m_off:m_off + (1 << lv)], lv)
            if node.kind not in LEAF_KINDS:
                raise AssertionError("a body above kl is a leaf")
            entries += _leaf_entries(node.kind, lv, p, int(mrows[i]), level,
                                     bool(need_hard), bool(do_cw), bool(do_u))
        elif kind == F:
            entries.append([S_F, h, s, s + h, -1, child, -1, 0])
        elif kind == G:
            entries.append([S_G, h, s, s + h, _row(HARD, p), child, -1, 0])
        elif kind == G0:
            entries.append([S_ADD, h, s, s + h, -1, child, -1, 0])
        elif kind in (COMB, COMB0):
            both = []
            for on, arr in ((need_hard, HARD), (do_cw, CW)):
                if on:
                    lo, hi = _row(arr, p), _row(arr, p + h)
                    both.append([S_HMUL, h, lo, hi, -1, lo, -1, 0]
                                if kind == COMB else
                                [S_COPY, h, hi, -1, -1, lo, -1, 0])
            if len(both) == 2:
                both[0][0] |= CHAIN
            entries += both
        elif kind == GRATE1:
            u = _row(U, int(mrows[i]))
            t = (u if do_cw else _row(PYR, 0)) if do_u else _row(CW, p + h)
            entries.append([S_GRATE1, h, s, s + h, _row(HARD, p), t,
                            _row(HARD, p + h) if need_hard else -1, 0])
            _transform(entries, t, t, h,              # u = T(hr)
                       to=None if do_cw or not do_u else u)
            if do_cw:                                 # cw_r = T(T(hr))
                _transform(entries, t, _row(CW, p + h), h)
                entries.append([S_HMUL, h, _row(CW, p), _row(CW, p + h), -1,
                                _row(CW, p), -1, 0])
        else:  # pragma: no cover
            raise AssertionError(kind)
        origin += [i] * (len(entries) - before)
        i += 1
    fills = []
    if prefill and grid_steps:   # +1 where no tile run writes back
        edges, start = sorted(covered), 0
        gaps = []
        for a, b in edges + [(n, n)]:
            if a > start:
                gaps.append((start, a))
            start = max(start, b)
        for arr in (HARD,) + ((CW,) if want_cw else ()):
            fills += [[S_FILL | CHAIN, b - a, -1, -1, -1, _row(arr, a), -1, 0]
                      for a, b in gaps]
        if fills:
            fills[-1][0] &= ~CHAIN
    entries = fills + entries
    origin = [-1] * len(fills) + origin
    region = max((r for _, _, r, _ in runs), default=1)
    if (2 + want_cw) * (TILE_FRAMES << region) > SMEM_BYTES:
        raise ValueError(f"a tile run rooted at level {region} does not fit "
                         f"a block's shared memory: lower grid_level")
    table_ = np.asarray(entries, np.int32).reshape(-1, SCHED_COLS)
    grid = table_[:, 0] & 0xFF != RUN
    if want_u and not want_cw:   # csrc/interp.cu's frame-major accesses
        arrays = np.where(table_[grid, 2:7] >= 0,
                          table_[grid, 2:7] >> ROW_BITS, -1)
        if (arrays[:, 2:] == IN).any() or (arrays[:, :3] == U).any():
            raise AssertionError(  # pragma: no cover
                "a frame-major entry reads u or the root out of place")
    barriers = int(((table_[:-1, 0] & CHAIN) == 0).sum()) if grid.any() else 0
    max_rows = int(table_[grid, 1].max()) if grid.any() else 0
    return Schedule(table_, mrows, g, region, runs, grid_steps, barriers,
                    max_rows, np.asarray(origin, np.int32))


# -- the kernels --------------------------------------------------------------

launches = {"interp_decoder": 0, "interp_decoder_frames": 0,
            "interp_decode_count": 0, "interp_subtree": 0}
plain_calls = {"interp_plain": 0}
_occupancy: dict = {}


@dataclass
class _Compiled:
    """A program ready to run: words, descriptors, table, its level and
    ``kl``, the frozen mask of its code or node, and its schedule."""

    words: np.ndarray
    desc: np.ndarray
    table: np.ndarray
    level: int
    kl: int
    mask: np.ndarray
    ones_init: bool
    steps: int
    branches: int
    sched: Schedule
    prefill: bool
    want_cw: bool
    want_u: bool
    _dev: dict = field(default_factory=dict)

    def device_args(self, dev):
        """Device copies of words, descriptors, table, the schedule and the
        message rows, once per device."""
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = tuple(torch.tensor(a, device=dev) for a in (
                self.words, self.desc.reshape(-1), self.table,
                self.sched.entries.reshape(-1), self.sched.mrows))
        return self._dev[key]

    def info(self) -> dict:
        """The schedule's size, for the reports, with the transform and
        fold stages a tile runs in its tile runs' bodies and grate1s in
        registers and in shared memory (:func:`tile_stages.program_stages`
        at the tile's shape)."""
        s = self.sched
        return {"steps": self.steps, "grid_level": s.grid_level,
                "grid_steps": len(s.grid_steps), "tile_runs": len(s.runs),
                "entries": len(s.entries), "barriers": s.barriers,
                "region_level": s.region_level, **self.tile_stages()}

    def tile_stages(self, frames: bool = False) -> dict:
        """``{"reg_stages", "smem_stages"}`` of one tile over every tile
        run of the schedule (``frames``: the frame-major u track's
        instance, REP's folds in shared memory)."""
        block = tile_stages.block_rows(TILE_WR, TILE_VW)
        counts = []
        for ws, we, _, _ in self.sched.runs:
            for w in self.words[ws:we].tolist():
                kind, lv, _, _, cw, _, off, _ = self.desc[w & 0xFFFF].tolist()
                do_cw = self.want_cw and bool(cw)
                if kind == BODY:
                    counts.append(tile_stages.program_stages(
                        self.table[off:], block, self.want_cw,
                        folds=not frames))
                elif kind == GRATE1:
                    r, m = tile_stages.transform_stages(1 << (lv - 1), block)
                    counts.append({"reg_stages": r * (1 + do_cw),
                                   "smem_stages": m * (1 + do_cw)})
        return tile_stages.add_stages(*counts)


def _compile(tree: Node, mask, subtree_level: int, want_cw: bool,
             want_u: bool, root_need_hard: bool = False, *,
             prefill_all: bool = False,
             grid_level: int | None = None) -> _Compiled:
    """The program of ``tree`` at ``min(subtree_level, tree.level)`` and
    its schedule at ``grid_level`` (by default :data:`INTERP_GRID_LEVEL`):
    hard, cw and u start at +1 where the program skips a rate-0 node, or
    with ``prefill_all`` (the whole-code decoder's u track, as the JAX
    kernel prefills it)."""
    kl = min(subtree_level, tree.level)
    prog = build_program(tree, kl, want_cw, want_u, root_need_hard)
    words = prog.words(kl)
    desc, table = tables(prog)
    prefill = prog.ones_init or prefill_all
    mask = np.asarray(mask, np.uint8)
    sched = schedule(words, desc, table, tree.level, kl, mask,
                     grid_level=(INTERP_GRID_LEVEL if grid_level is None
                                 else grid_level),
                     want_cw=want_cw, want_u=want_u,
                     prefill=prefill)
    return _Compiled(words, desc, table, tree.level, kl, mask,
                     prog.ones_init, len(prog.steps), len(prog.branches),
                     sched, prefill, want_cw, want_u)


def _check_llr(llr_t, n, what, frames: bool = False):
    """Raises ``ValueError`` unless ``llr_t`` is a contiguous int8 tensor
    of ``(N, B)`` (``frames``: ``(B, N)`` on 16 bytes)."""
    if (llr_t.dtype != torch.int8 or llr_t.ndim != 2
            or llr_t.shape[int(frames)] != n or not llr_t.is_contiguous()
            or frames and llr_t.data_ptr() % 16):
        want = f"(B, N={n}) on 16 bytes" if frames else f"(N={n}, B)"
        raise ValueError(f"{what}: expected contiguous {want} int8, got "
                         f"{tuple(llr_t.shape)} {llr_t.dtype}")


def _plan(c: _Compiled, dev, b: int, frames: bool = False) -> dict:
    """The tile kernel's launch for ``b`` frames on ``dev`` (``frames``:
    the frame-major u track's): warps (tiles) a block, blocks, dynamic
    shared memory, cooperative or not. A cooperative grid holds no more
    blocks than the card keeps resident at once (the occupancy the runtime
    reports for this kernel and block), and no more than its tiles or its
    largest grid entry's items need. Call after ``build.stream(dev)``."""
    s = c.sched
    per_warp = (2 + c.want_cw) * (TILE_FRAMES << s.region_level)
    warps = max(1, min(TILE_MAX_WARPS, SMEM_BYTES // per_warp))
    smem = max(per_warp, STAGE_BYTES if frames else 0)   # bytes a warp
    tiles = -(-b // TILE_FRAMES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if not s.cooperative:   # one warp a tile while few tiles a block
        if tiles < 2 * TILE_MAX_WARPS * sms:
            warps = 1
        return {"warps": warps, "blocks": -(-tiles // warps),
                "smem": warps * smem, "cooperative": False}
    key = (str(dev), c.want_cw, c.want_u, frames, s.region_level, warps)
    if key not in _occupancy:
        per_sm = ctypes.c_int(0)
        build.check(build.load_library().polar_interp_tile_occupancy(
            int(c.want_cw), int(c.want_u), int(frames), s.region_level,
            warps, ctypes.byref(per_sm)), "polar_interp_tile_occupancy")
        if per_sm.value < 1:
            raise RuntimeError("the interp tile kernel's block does not fit "
                               "an SM")
        _occupancy[key] = per_sm.value * sms
    items = s.max_rows * -(-b // CHUNK_FRAMES)
    need = max(-(-tiles // warps), -(-items // (32 * warps)))
    return {"warps": warps, "blocks": min(_occupancy[key], need),
            "smem": warps * smem, "cooperative": True}


def _launch_plan(c: _Compiled, batch: int, dev="cuda",
                 frames: bool = False) -> dict:
    """:func:`_plan` of ``c`` for ``batch`` frames on CUDA device ``dev``
    (``frames``: the frame-major u track's), with its schedule's size."""
    dev = torch.device(dev)
    build.stream(dev)
    return {**c.info(), **c.tile_stages(frames), **_plan(c, dev, batch,
                                                         frames)}


def _run_tile(c: _Compiled, llr_t, *, hard_out: bool, what: str,
              frames: bool = False):
    """Launch the tile kernel on ``c``'s schedule: returns ``(hard, cw,
    u)``, u compacted into K rows, hard None unless ``hard_out`` (or the
    grid steps need it). ``frames``: ``llr_t`` is frame-major, a contiguous
    ``(B, N)`` int8 tensor on 16 bytes, and u comes back ``(B, K)``; the u
    track alone, its grid entries from level ``FRAMES_GRID_LEVEL``
    (``ValueError`` else)."""
    start = profiling.begin()
    n = 1 << c.level
    if frames:
        if c.want_cw or hard_out:
            raise ValueError("the frame-major layout is the interpreter's u "
                             "track alone: no cw track, no hard rows")
        if c.sched.cooperative and c.level < FRAMES_GRID_LEVEL:
            raise ValueError(f"the frame-major layout's grid entries start "
                             f"at level {FRAMES_GRID_LEVEL}, not {c.level}")
        _check_llr(llr_t, n, what, frames=True)
    dev = llr_t.device
    b = llr_t.shape[0 if frames else 1]
    k = int(np.count_nonzero(c.mask == 0))
    sched = c.sched
    coop = sched.cooperative
    hard = (torch.empty((n, b), dtype=torch.int8, device=dev)
            if hard_out or coop else None)
    cw = (torch.empty((n, b), dtype=torch.int8, device=dev)
          if c.want_cw else None)
    u = (torch.empty((b, k) if frames else (k, b), dtype=torch.int8,
                     device=dev) if c.want_u else None)
    if b == 0:
        return hard, cw, u
    stream = build.stream(dev)
    pyr = (torch.empty((n + 1, b), dtype=torch.int8, device=dev)
           if coop else None)
    plan = _plan(c, dev, b, frames)
    words, desc, table, entries, mrows = (
        a.data_ptr() for a in c.device_args(dev))
    lanes = (pyr, hard, cw) if frames else (llr_t, pyr, hard, cw, u)
    aligned = b % CHUNK_FRAMES == 0 and all(t.data_ptr() % 16 == 0
                                            for t in lanes if t is not None)
    err = build.load_library().polar_interp_tile(
        words, desc, table, mrows, entries, len(sched.entries), c.level,
        c.kl, b, int(c.prefill), int(aligned), sched.region_level,
        llr_t.data_ptr(), *(t.data_ptr() if t is not None else None
                            for t in (pyr, hard, cw, u)),
        int(c.want_cw), int(c.want_u), int(frames), k, plan["blocks"],
        plan["warps"], int(plan["cooperative"]), stream)
    build.check(err, "polar_interp_tile")
    profiling.launched(start, launches, what)
    return hard, cw, u


def make_interp_decoder(code: PolarCode, tree: Node | None = None, *,
                        subtree_level: int = 10, output: str = "u",
                        output_dtype=torch.int8):
    """The interpreter whole-code decoder, with the eager decoder's
    contract: ``decode(llrs (B, N))`` → u ``(B, K)`` / systematic
    ``(B, K)`` / codeword ``(B, N)`` / both, and ``decode.lane_major(llr_t
    (N, B))`` with the code axis leading; ``decode.plain(llr_t)`` is the
    plain version of ``lane_major`` on any device. ``decode.program_steps``
    and ``decode.program_branches`` give the program's size,
    ``decode.schedule`` its tile-kernel schedule and ``decode.plan(batch)``
    its launch (the u output's frame-major one), with the register
    block's stage counts. ``subtree_level``: nodes at or below it are bodies;
    ``output_dtype`` casts the outputs. Any batch.

    With the u output, ``decode`` on a card hands the kernel the ``(B,
    N)`` LLRs as given (made contiguous, copied if off 16 bytes) and takes
    u ``(B, K)`` back: the
    kernel's frame-major u track, counted under ``interp_decoder_frames``,
    with no transpose. The cw outputs and CPU tensors go through the
    element-major entry and a transpose in and out
    (``fastssc.frame_major``)."""
    if tree is None:
        tree = compile_code(code)
    if output not in ("u", "systematic", "codeword", "both"):
        raise ValueError(f"unknown output mode {output!r}")
    want_cw = output != "u"
    want_u = output in ("u", "both")
    c = _compile(tree, code.frozen, subtree_level, want_cw, want_u,
                 prefill_all=want_u)
    n = code.N

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
                                prefill=c.prefill)
        info = torch.as_tensor(code.info_indices, device=llr_t.device)
        return by_mode(u[info] if want_u else None, cw)

    def lane_major(llr_t):
        _check_llr(llr_t, n, "interp decoder")
        if llr_t.device.type == "cpu":
            return plain(llr_t)
        if llr_t.device.type != "cuda":
            raise ValueError(f"no interp decoder for device {llr_t.device}")
        _, cw, u = _run_tile(c, llr_t, hard_out=False, what="interp_decoder")
        return by_mode(u, cw)

    transposing = frame_major(lane_major, "interp decoder")

    def decode(llrs):
        if output != "u" or llrs.device.type != "cuda":
            return transposing(llrs)
        if llrs.ndim != 2:
            raise ValueError("interp decoder expects (batch, N) LLRs")
        with profiling.annotate("decode"):
            x = llrs.contiguous()
            if x.data_ptr() % 16:   # a view off 16 bytes
                x = x.clone()
            _, _, u = _run_tile(c, x, hard_out=False,
                                what="interp_decoder_frames", frames=True)
            return u.to(output_dtype)

    decode.lane_major = lane_major
    decode.plain = plain
    decode.program_steps = c.steps
    decode.program_branches = c.branches
    decode.schedule = c.info()
    decode.plan = functools.partial(_launch_plan, c, frames=output == "u")
    decode.compiled = c
    return decode


def make_interp_decode_count(code: PolarCode, tree: Node | None = None, *,
                             subtree_level: int = 10):
    """``count(llr_t, cw_t)`` → the five counters (``(5,)`` int64, in
    ``step_kernel.COUNTERS`` order) of the interpreter decode on the
    codeword-estimate track against ``cw_t`` at the info rows, with the
    AWGN and quantization counters of ``llr_t``; both ``(N, B)`` int8.
    ``count.plain`` is its plain version on any device. On a card: the
    tile kernel's cw track, then the counter kernel
    (``count_kernel.count``, ``csrc/count.cu``) on the same stream."""
    if tree is None:
        tree = compile_code(code)
    c = _compile(tree, code.frozen, subtree_level, True, False)
    n = code.N

    def plain(llr_t, cw_t):
        _, cw_hat, _ = interp_plain(c.words, c.desc, c.table, c.level, c.kl,
                                    llr_t, want_cw=True, want_u=False,
                                    prefill=c.prefill)
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
        _, cw_hat, _ = _run_tile(c, llr_t, hard_out=False,
                                 what="interp_decode_count")
        return count_kernel.count(code.frozen, llr_t, cw_t, cw_hat)

    count.plain = plain
    count.schedule = c.info()
    count.plan = functools.partial(_launch_plan, c)
    count.compiled = c
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
    n = 1 << node.level
    info = info_positions(node)

    def outs(hard, cw, u):
        return ((u,) if emit_u else ()) + (hard,) + ((cw,) if emit_cw else ())

    def plain(slot):
        hard, cw, u = interp_plain(c.words, c.desc, c.table, c.level, c.kl,
                                   slot, want_cw=emit_cw, want_u=emit_u,
                                   prefill=c.prefill)
        return outs(hard, cw, u[torch.as_tensor(info, device=slot.device)]
                    if emit_u else None)

    def run(slot):
        _check_llr(slot, n, "interp subtree")
        if slot.device.type == "cpu":
            return plain(slot)
        if slot.device.type != "cuda":
            raise ValueError(f"no interp subtree decoder for device "
                             f"{slot.device}")
        return outs(*_run_tile(c, slot, hard_out=True, what="interp_subtree"))

    run.plain = plain
    run.schedule = c.info()
    run.plan = functools.partial(_launch_plan, c)
    run.compiled = c
    return run
