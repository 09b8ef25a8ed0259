"""Subtree Fast-SSC decoder on the card: wrapper and plain version.

The kernels replace ``polar_tpu/ops/pallas/decoder_kernel.py:
make_subtree_decoder`` (``:562``) in its SSA bodies and ``"lane"`` layout:
each decodes one pruned-tree node for the hybrid decoder
(:mod:`polar_tpu_torch.decode.fastssc`) over element-major ``(rows, B)``
int8 blocks.

``make_subtree_decoder(node, ...)`` returns ``fn(*blocks)``:

* inputs — the node's slot ``(2^l, B)``; with ``fuse="f"`` the parent's
  slot ``(2^{l+1}, B)`` (the parent's f runs in the kernel); with
  ``fuse="g"`` the parent's slot plus the left child's hard block (and its
  cw block when ``emit_cw``), the parent's g running in the kernel;
* outputs — ``(u (k, B))?``, ``hard``, ``(cw)?``; ``hard`` and ``cw`` are
  the node's ``(2^l, B)`` blocks, or under ``fuse="g"`` the parent's
  combined ``[hl·hr, hr]`` / ``[cwl·cwr, cwr]`` ``(2^{l+1}, B)`` blocks.

Styles:

* ``"ssa"`` — up to level :data:`TILE_SUBTREE_MAX_LEVEL` the tile kernel
  (``csrc/subtree.cu`` over ``csrc/fastssc_simd.cuh``): a warp decodes
  ``decoder_kernel.WHOLE_FRAMES`` frames, four to a 32-bit word, the
  node's root rows, pyramid and stacks in shared memory, the cw track
  built per node. Above it, where one tile no longer fits a block, the
  walk;
* ``"walk"`` — the same function by one thread a frame over device-memory
  scratch (``csrc/subtree.cu`` over ``csrc/fastssc.cuh``), the cw block a
  re-encode at the end: the nodes above the tile's limit, and by name for
  the A/B;
* ``"scratch"`` (``csrc/scratch.cu``) replaces the scratch body
  ``_subtree_kernel`` (``:550``): u and hard only, no fusion, the node's
  pyramid and hard stack in shared memory, the root read in device memory
  (no copy on chip), on the tile core at the shape and block that
  ``decoder_kernel.scratch_shape`` picks for the node's level and the
  call's batch (level at most ``decoder_kernel.SCRATCH_MAX_LEVEL``; above
  it, as the other refusals, ``ValueError`` when the decoder is made).

The function launches the kernel for CUDA tensors and runs
:func:`decode_plain` (the eager recursion over the node) only for CPU
tensors; :data:`launches` counts the launches per kernel.
"""

from __future__ import annotations

import torch

from ...code.compiler import Node, emit_program, node_frozen
from ...decode.fastssc import _TreeDecoder
from ...ops.arith import Int8Arith
from ...utils import profiling
from . import build
from .decoder_kernel import (STYLES, THREADS, device_tables, scratch_aligned,
                             scratch_frames, scratch_shape, tile_max_level,
                             tile_warps)

FUSE_CODES = {None: 0, "f": 1, "g": 2}
# The tile subtree keeps the node's root rows on chip beside the soft
# pyramid, the hard stack and the cw stack: n bytes a frame each
# (decoder_kernel.tile_bytes with root=True). Its limit is the largest level
# at which one such tile on the cw track fits a block's shared memory (12);
# every node of the hybrid at its default kernel level (9) fits, and nodes
# above the limit go to the walk.
TILE_SUBTREE_MAX_LEVEL = tile_max_level(root=True)
# "subtree_decoder": the tile kernel, "walk_subtree": the walk
launches = {"subtree_decoder": 0, "walk_subtree": 0, "scratch_subtree": 0}
plain_calls = {"subtree_plain": 0}


def ssa_kernel(level: int) -> str:
    """The kernel of style ``"ssa"`` for a node of this level: ``"tile"``
    up to :data:`TILE_SUBTREE_MAX_LEVEL`, ``"walk"`` above it."""
    return "tile" if level <= TILE_SUBTREE_MAX_LEVEL else "walk"


def decode_plain(node: Node, blocks, *, fuse=None, emit_u=True,
                 emit_cw=False) -> tuple:
    """The eager recursion over ``node`` on element-major int8 blocks,
    with the fused parent f / g and combine of the kernel."""
    plain_calls["subtree_plain"] += 1
    dec = _TreeDecoder(Int8Arith(), want_cw=emit_cw, axis=0)
    if fuse == "f":
        x = dec._f(blocks[0])
    elif fuse == "g":
        x = dec._g(blocks[1], blocks[0])
    else:
        x = blocks[0]
    hard, cw = dec.decode(node, x)
    if fuse == "g":
        hard = torch.cat([dec.ph.qmul(blocks[1], hard), hard], dim=0)
        if emit_cw:
            cw = torch.cat([blocks[2] * cw, cw], dim=0)
    outs = (hard,) + ((cw,) if emit_cw else ())
    return ((torch.cat(dec.mesg, dim=0),) if emit_u else ()) + outs


def make_subtree_decoder(node: Node, *, emit_u: bool = True,
                         emit_cw: bool = False, fuse: str | None = None,
                         style: str = "ssa",
                         shape: tuple[int, int, int] | None = None):
    """The decoder of one node (see the module docstring). Any batch.
    ``shape``: ``(wr, vw, warps)`` of the scratch tile kernel in place of
    ``decoder_kernel.scratch_shape``'s (the A/B and the tests)."""
    if node.mesg_bits < 1:
        raise ValueError("only nodes that emit message bits take a kernel")
    if not emit_u and not emit_cw:
        raise ValueError("emit_u=False needs emit_cw")
    if fuse not in FUSE_CODES:
        raise ValueError(f"unknown fuse mode {fuse!r}")
    if style not in STYLES:
        raise ValueError(f"unknown kernel style {style!r}")
    n, k = 1 << node.level, node.mesg_bits
    if style == "scratch":
        if emit_cw or fuse:
            raise ValueError("emit_cw and fuse require the SSA kernel style")
        scratch_frames(n)
    if fuse == "g":
        in_rows = (2 * n, n) + ((n,) if emit_cw else ())
    else:
        in_rows = (2 * n,) if fuse == "f" else (n,)
    out_n = 2 * n if fuse == "g" else n
    program = emit_program(node, node.level)
    frozen = node_frozen(node)

    def run(*blocks):
        start = profiling.begin()
        if len(blocks) != len(in_rows):
            raise ValueError(f"expected {len(in_rows)} input blocks")
        dev = blocks[0].device
        if dev.type == "cpu":
            return decode_plain(node, blocks, fuse=fuse, emit_u=emit_u,
                                emit_cw=emit_cw)
        if dev.type != "cuda":
            raise ValueError(f"no subtree decoder for device {dev}")
        b = blocks[0].shape[1] if blocks[0].ndim == 2 else -1
        for t, rows in zip(blocks, in_rows):
            if (t.dtype != torch.int8 or tuple(t.shape) != (rows, b)
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(
                    f"expected contiguous int8 blocks of {in_rows} rows and "
                    f"one batch on {dev}, got "
                    f"{[(tuple(x.shape), x.dtype) for x in blocks]}")
        mesg = torch.empty((k, b), dtype=torch.int8, device=dev)
        hard = torch.empty((out_n, b), dtype=torch.int8, device=dev)
        cw = (torch.empty((out_n, b), dtype=torch.int8, device=dev)
              if emit_cw else None)
        outs = ((mesg,) if emit_u else ()) + (hard,) + ((cw,) if emit_cw else ())
        if b == 0:
            return outs
        stream = build.stream(dev)
        prog_d, frozen_d = device_tables(program, frozen, dev)
        lib = build.load_library()
        if style == "scratch":
            wr, vw, warps = shape or scratch_shape(node.level, b)
            err = lib.polar_scratch_subtree(
                prog_d.data_ptr(), n, b, blocks[0].data_ptr(), mesg.data_ptr(),
                hard.data_ptr(), wr, vw, warps,
                int(scratch_aligned(b, vw, (blocks[0], mesg, hard))), stream)
            build.check(err, "polar_scratch_subtree")
            profiling.launched(start, launches, "scratch_subtree")
            return outs
        ptr = [t.data_ptr() for t in blocks] + [None] * (3 - len(blocks))
        if style == "ssa" and ssa_kernel(node.level) == "tile":
            aligned = b % 16 == 0 and all(
                t.data_ptr() % 16 == 0 for t in blocks + outs)
            err = lib.polar_tile_subtree(
                prog_d.data_ptr(), n, b, FUSE_CODES[fuse], *ptr,
                mesg.data_ptr() if emit_u else None, hard.data_ptr(),
                cw.data_ptr() if emit_cw else None,
                tile_warps(n, emit_cw, root=True), int(aligned), stream)
            build.check(err, "polar_tile_subtree")
            profiling.launched(start, launches, "subtree_decoder")
            return outs
        soft = torch.empty((n, b), dtype=torch.int8, device=dev)
        child = (torch.empty((n, b), dtype=torch.int8, device=dev)
                 if fuse else None)
        err = lib.polar_subtree(
            prog_d.data_ptr(), frozen_d.data_ptr(), n, b, FUSE_CODES[fuse],
            *ptr, child.data_ptr() if fuse else None, soft.data_ptr(),
            mesg.data_ptr(), hard.data_ptr(),
            cw.data_ptr() if emit_cw else None, THREADS, stream)
        build.check(err, "polar_subtree")
        profiling.launched(start, launches, "walk_subtree")
        return outs

    return run
