"""Whole-code Fast-SSC decoder on the card: wrapper and plain version.

Three kernels, two styles of ``polar_tpu/ops/pallas/decoder_kernel.py``'s
``make_pallas_decoder``:

* ``"ssa"`` replaces ``_ssa_decoder_kernel`` (u track, ``:404``) and
  ``_ssa_decoder_kernel_cw`` (codeword-estimate track, ``:410``): û
  ``(K, B)`` and, on the cw track, the codeword estimate ``(N, B)`` =
  ``encode(code, û)`` from element-major ``(N, B)`` int8 LLRs. Up to
  level :data:`WHOLE_MAX_LEVEL` it is the tile kernel (``csrc/decoder.cu``
  over ``csrc/fastssc_simd.cuh``): a warp decodes :data:`WHOLE_FRAMES`
  frames, four to a 32-bit word, its lanes splitting each node's rows, the
  pyramid and stacks in shared memory, the cw track built per node. Above
  it, where one tile's 3N bytes a frame no longer fit a block, it is the
  walk;
* ``"walk"`` (``csrc/decoder.cu`` over ``csrc/fastssc.cuh``), the same
  function by one thread a frame over device-memory scratch, the cw track
  a re-encode at the end: the codes above :data:`WHOLE_MAX_LEVEL`, and by
  name for the A/B;
* ``"scratch"`` (``csrc/scratch.cu``) replaces ``_decoder_kernel``
  (``:541``), u track only: the tile core of ``csrc/fastssc_simd.cuh``
  with the pyramid and the hard stack in shared memory, 2N bytes a frame,
  the root read in device memory, at a tile shape and block that
  :func:`scratch_shape` picks by level and batch from
  :data:`SCRATCH_SHAPES`; N is at most 2^:data:`SCRATCH_MAX_LEVEL`
  (:func:`scratch_frames` raises above).

:func:`decode` launches the kernel for a CUDA tensor and runs
:func:`decode_plain` (the eager decoder) only for a CPU tensor; it keeps
a count of its launches per kernel and track in :data:`launches`. The
tile kernels' u track
also takes frame-major ``(B, N)`` LLRs and writes û ``(B, K)`` itself
(``layout="frames"``, :func:`has_frames`), counted under the kernel's key
with ``_frames`` at the end.
:func:`decode_f32` is the u track in float32 min-sum (the eager decoder's
arithmetic on float LLRs, ``polar_helper.hh:63-111``): the tile core with
one frame to a 32-bit word, frame-major ``(B, N)`` float32 in, ``(B, K)``
int8 out, up to level :data:`F32_MAX_LEVEL`.
:func:`simd_selftest` holds the tile kernel's packed functions against
the walk's scalar ones on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ...code.compiler import build_tree, emit_program
from ...code.construction import PolarCode
from ...decode.fastssc import make_fastssc_decoder
from ...utils import profiling
from . import build, tile_stages

# Frames (threads) per block of the walk. On an H100 at Polar(1024, 512) 128 was as fast as or faster than 64 at B = 4096,
# 32768 and 131072; 256 was faster still at B = 32768 but a third slower at
# B = 4096 (PERF.md).
THREADS = 128
STYLES = ("ssa", "walk", "scratch")
# The shared memory a block may take on an H100 (227 KB). The scratch style
# takes N up to the largest at which 32 frames of 2N bytes fit a block.
SCRATCH_SMEM_BYTES = 232448
SCRATCH_MAX_FRAMES = 128
SCRATCH_MAX_LEVEL = (SCRATCH_SMEM_BYTES // (2 * 32)).bit_length() - 1   # 11
# The tile kernel: frames a tile (one warp), the one shape csrc/decoder.cu
# builds (all 8 of a row on one lane). It was picked on an H100 for
# Polar(1024, 512), the main path's code, by a design probe the repo does
# not keep: there it led at B = 4096 and came within a few per cent of
# 16-frame tiles at B = 32768; it tied 4-frame tiles at level 12 and lost
# to them at level 13 (a tile shape by level is queued in ROADMAP.md as an
# A/B). A block holds as many tiles as fit WHOLE_BLOCK_BYTES (at least one,
# at most WHOLE_MAX_WARPS). A tile takes 2N (u) or 3N (cw) bytes a frame;
# WHOLE_MAX_LEVEL is the largest level at which one tile on the cw track
# fits a block's shared memory (13). Above it "ssa" runs the walk. One tile
# an SM is enough: at level 13 it still beat the walk (step_ab
# --decoders-only, lane-major), 22.9 / 28.6 against 27.1 / 51.5 ms (u / cw)
# at B = 32768 and 2.96 / 3.71 against 16.8 / 31.5 at B = 4096.
WHOLE_FRAMES = 8
WHOLE_BLOCK_BYTES = 16384
WHOLE_MAX_WARPS = 8
SIMD_PRIMITIVES = ("sat_add", "qabs", "signum", "decide", "prod", "madd",
                   "hmul", "spc_flip")
LAYOUTS = ("lanes", "frames")
launches = {"fastssc_decoder_u": 0, "fastssc_decoder_cw": 0,
            "walk_decoder_u": 0, "walk_decoder_cw": 0, "scratch_decoder": 0,
            "fastssc_decoder_u_frames": 0, "scratch_decoder_frames": 0,
            "f32_decoder_frames": 0}
plain_calls = {"decode_plain": 0}
_tables: dict = {}


def device_tables(program: np.ndarray, frozen: np.ndarray, device):
    """Device copies (uint8) of a code's byte program and frozen mask,
    made once per code and device after checking that the program was
    emitted from the mask (the kernel trusts it)."""
    key = (program.tobytes(), frozen.tobytes(), str(device))
    if key not in _tables:
        _code(program, frozen)
        _tables[key] = tuple(
            torch.tensor(np.asarray(a, dtype=np.uint8), device=device)
            for a in (program, frozen))
    return _tables[key]


def device_mask(frozen: np.ndarray, device):
    """Device copy (uint8) of a frozen mask, made once per mask and
    device."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    key = ("mask", frozen.tobytes(), str(device))
    if key not in _tables:
        _tables[key] = torch.tensor(frozen, device=device)
    return _tables[key]


def device_info(frozen: np.ndarray, device):
    """Device copy (int32) of a frozen mask's info rows in increasing
    order, the message's emission order, made once per mask and device."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    key = ("info", frozen.tobytes(), str(device))
    if key not in _tables:
        _tables[key] = torch.tensor(np.flatnonzero(frozen == 0),
                                    dtype=torch.int32, device=device)
    return _tables[key]


def _code(program, frozen):
    """The code and node tree that ``program`` was emitted from."""
    program = np.asarray(program, dtype=np.uint8)
    frozen = np.asarray(frozen, dtype=np.uint8)
    level = int(program[0])
    tree = build_tree(frozen, level)
    if not np.array_equal(emit_program(tree, level), program):
        raise ValueError("program was not emitted from this frozen mask")
    return PolarCode(level, frozen), tree


def decode_plain(program, frozen, llr_t, want_cw: bool):
    """Eager decode of element-major ``(N, B)`` int8 LLRs.

    Returns ``(u (K, B), cw (N, B) or None)``, int8."""
    plain_calls["decode_plain"] += 1
    code, tree = _code(program, frozen)
    dec = make_fastssc_decoder(code, tree, output="both" if want_cw else "u",
                               output_dtype=torch.int8).lane_major
    out = dec(llr_t)
    return out if want_cw else (out, None)


def scratch_frames(n: int) -> int:
    """Frames a block of the scratch style at code length ``n``: the most,
    a multiple of 32 up to :data:`SCRATCH_MAX_FRAMES`, whose 2n bytes each
    fit a block's shared memory. Raises ``ValueError`` where one warp of
    frames does not fit (n > 2^SCRATCH_MAX_LEVEL)."""
    frames = min(SCRATCH_MAX_FRAMES, SCRATCH_SMEM_BYTES // (2 * n) // 32 * 32)
    if frames < 32:
        raise ValueError(
            f"the scratch style keeps 2N bytes a frame in shared memory: "
            f"N={n} needs {64 * n} bytes for 32 frames, above the "
            f"{SCRATCH_SMEM_BYTES} a block may take (N <= "
            f"{1 << SCRATCH_MAX_LEVEL}, level {SCRATCH_MAX_LEVEL})")
    return frames


# The scratch tile kernel's shapes (csrc/scratch.cu): (WR, VW), WR words of
# four frames a warp's tile, VW of them a lane, 32 VW / WR rows a pass.
SCRATCH_SHAPES = ((2, 2), (4, 1), (8, 1), (32, 1))
SCRATCH_SMS = 132        # an H100's SMs: the grid covers them where it can
# (WR, VW, warps a block) by level, for calls below SCRATCH_BATCHES[0]
# frames, below SCRATCH_BATCHES[1], and from it. scratch_shape cuts the
# warps to what shared memory holds and to a grid that covers the card.
# From the shape A/B (python -m polar_tpu_torch.utils.step_ab
# --scratch-shapes --levels 1-11; NVIDIA H100 80GB HBM3, 700.00 W; device
# ms of one u decode of Polar(2^m, 2^(m-1)), host time hidden, each arm
# twice in mirrored order; every shape at 1, 2, 4, 8 warps where the block
# holds them and the grid covers the card): the fastest arm at B = 4096 /
# 16384 / 32768, beside the byte kernel and the SSA style's tile kernel:
#   m    B=4096                B=16384               B=32768
#   1    32x1w1 .0026 (.0026)  32x1w1 .0027 (.0027)  32x1w1 .0027 (.0027)
#   2    2x2w2  .0033 (.0035)  8x1w2  .0033 (.0036)  8x1w4  .0034 (.0036)
#   3    8x1w1  .0043 (.0051)  8x1w2  .0043 (.0052)  8x1w4  .0044 (.0053)
#   4    4x1w1  .0046 (.0068)  4x1w4  .0048 (.0069)  8x1w4  .0053 (.0071)
#   5    2x2w2  .0088 (.0140)  4x1w4  .0096 (.0142)  8x1w4  .0105 (.0155)
#   6    2x2w2  .0123 (.0276)  4x1w4  .0152 (.0275)  4x1w4  .0181 (.0302)
#   7    2x2w2  .0192 (.0554)  4x1w4  .0256 (.0554)  4x1w8  .0316 (.0632)
#   8    2x2w1  .0342 (.1069)  2x2w8  .0491 (.1068)  4x1w8  .0600 (.1305)
#   9    2x2w2  .0588 (.2101)  2x2w8  .0857 (.2128)  2x2w8  .1606 (.4426)
#   10   2x2w1  .1079 (.5045)  2x2w4  .2327 (.9741)  2x2w4  .3972 (1.862)
#   11   2x2w1  .2047 (1.060)  2x2w2  .6567 (5.206)  2x2w2  1.312 (10.63)
# (the byte kernel in brackets; the tile kernel read .0137 / .0168 / .0264
# at m = 6, .0339 / .0496 / .0866 at m = 8, .1079 / .2464 / .4312 at
# m = 10). Level 9 takes the largest level-9 node of Polar(131072, 65536)'s
# hybrid below 32768 frames, the hybrid's own case: 2x2w1 .0260 at B = 4096
# (2x2w2 .0263; the byte kernel .2068, the tile subtree with its root copy
# .0254) and 4x1w4 .0508 at B = 16384 (2x2w8 not among the best three;
# the byte kernel .2175, the tile subtree .0523). The 32x1 shape led only
# at m = 1, where every arm is a launch.
SCRATCH_BATCHES = (16384, 32768)
SCRATCH_TABLE = {
    1: ((32, 1, 1), (32, 1, 1), (32, 1, 1)),
    2: ((2, 2, 2), (8, 1, 2), (8, 1, 4)),
    3: ((8, 1, 1), (8, 1, 2), (8, 1, 4)),
    4: ((4, 1, 1), (4, 1, 4), (8, 1, 4)),
    5: ((2, 2, 2), (4, 1, 4), (8, 1, 4)),
    6: ((2, 2, 2), (4, 1, 4), (4, 1, 4)),
    7: ((2, 2, 2), (4, 1, 4), (4, 1, 8)),
    8: ((2, 2, 1), (2, 2, 8), (4, 1, 8)),
    9: ((2, 2, 1), (4, 1, 4), (2, 2, 8)),
    10: ((2, 2, 1), (2, 2, 4), (2, 2, 4)),
    11: ((2, 2, 1), (2, 2, 2), (2, 2, 2)),
}


def scratch_smem(n: int, wr: int, warps: int) -> int:
    """Shared memory of a block of the scratch tile kernel at code (or
    node) length ``n``: ``warps`` tiles of 4 ``wr`` frames, 2n bytes a
    frame."""
    return warps * 2 * n * 4 * wr


def scratch_shape(level: int, batch: int) -> tuple[int, int, int]:
    """``(wr, vw, warps)`` of the scratch tile kernel for a decode of
    ``batch`` frames at this level: :data:`SCRATCH_TABLE`'s shape, its warps
    a block cut to what a block's shared memory holds and then until the
    grid has at least ``min(SCRATCH_SMS, tiles)`` blocks. Raises
    ``ValueError`` where no tile fits (level > :data:`SCRATCH_MAX_LEVEL`)."""
    scratch_frames(1 << level)
    wr, vw, warps = SCRATCH_TABLE[level][sum(batch >= b
                                             for b in SCRATCH_BATCHES)]
    n = 1 << level
    warps = max(1, min(warps, SCRATCH_SMEM_BYTES // scratch_smem(n, wr, 1)))
    tiles = -(-max(batch, 1) // (4 * wr))
    warps = min(warps, tiles)
    while warps > 1 and -(-tiles // warps) < min(SCRATCH_SMS, tiles):
        warps -= 1
    return wr, vw, warps


def scratch_aligned(batch: int, vw: int, tensors) -> bool:
    """The tile kernel's fast path for shape width ``vw``: the batch a
    multiple of a lane's 4 vw bytes and every array on a 4 vw-byte
    boundary (else rows go a byte at a time)."""
    step = 4 * vw
    return batch % step == 0 and all(t.data_ptr() % step == 0
                                      for t in tensors)


def tile_bytes(n: int, want_cw: bool, root: bool = False) -> int:
    """Shared memory of one tile of the tile core at code (or node) length
    ``n``: soft pyramid and hard stack, the codeword stack on the cw track
    and, with ``root``, the root input on chip (the tile subtree decoder and
    the tile step), n bytes a frame each."""
    return (2 + want_cw + root) * n * WHOLE_FRAMES


def _warps_for(nbytes: int) -> int:
    """Tiles (warps) a block whose tiles take ``nbytes`` of shared
    memory each: as many as fit :data:`WHOLE_BLOCK_BYTES`, at least one, at
    most :data:`WHOLE_MAX_WARPS`; small codes so fill an SM's warps before
    its limit of 32 blocks."""
    return max(1, min(WHOLE_MAX_WARPS, WHOLE_BLOCK_BYTES // nbytes))


def tile_warps(n: int, want_cw: bool, root: bool = False) -> int:
    """Tiles (warps) a block of an int8 tile kernel (:func:`_warps_for`)."""
    return _warps_for(tile_bytes(n, want_cw, root))


def tile_max_level(root: bool) -> int:
    """The largest level at which one tile on the cw track (with the root
    on chip, or not) fits a block's shared memory."""
    return max(m for m in range(1, 20)
               if tile_bytes(1 << m, True, root) <= SCRATCH_SMEM_BYTES)


WHOLE_MAX_LEVEL = tile_max_level(root=False)


def ssa_kernel(n: int) -> str:
    """The kernel of style ``"ssa"`` at code length ``n``: ``"tile"`` up to
    level :data:`WHOLE_MAX_LEVEL`, ``"walk"`` above it."""
    return "tile" if n <= 1 << WHOLE_MAX_LEVEL else "walk"


def has_frames(style: str, n: int) -> bool:
    """Whether the kernel of ``style`` at code length ``n`` takes the
    frame-major layout (its u track): the tile kernel (``"ssa"`` up to
    :data:`WHOLE_MAX_LEVEL`) and the scratch tile kernel."""
    return style == "scratch" or (style == "ssa" and ssa_kernel(n) == "tile")


def _check_llrs(llr_t, n: int, frames: bool) -> None:
    """Raises ``ValueError`` unless ``llr_t`` is a contiguous int8 tensor of
    ``(B, N)`` (``frames``) or ``(N, B)``."""
    rows = 1 if frames else 0
    if (llr_t.dtype != torch.int8 or llr_t.ndim != 2
            or llr_t.shape[rows] != n or not llr_t.is_contiguous()):
        want = f"(B, N={n})" if frames else f"(N={n}, B)"
        raise ValueError(f"expected contiguous {want} int8 LLRs, got "
                         f"{tuple(llr_t.shape)} {llr_t.dtype}")


def decode(program, frozen, llr_t, want_cw: bool, style: str = "ssa",
           shape: tuple[int, int, int] | None = None, layout: str = "lanes"):
    """Decode element-major ``(N, B)`` int8 LLRs: the kernel of ``style``
    for a CUDA tensor, :func:`decode_plain` for a CPU one.

    ``program`` is ``compile_program(code)`` and ``frozen`` the code's
    mask, both numpy uint8. Returns ``(u (K, B), cw (N, B) or None)``.
    ``style="ssa"`` takes the tile kernel or the walk by
    :func:`ssa_kernel`; ``"walk"`` the walk at every level;
    ``"scratch"`` the u track only and N <= 2^11, on every device. ``shape``: ``(wr, vw, warps)`` of the scratch tile
    kernel in place of :func:`scratch_shape`'s (the A/B and the tests).
    ``layout="frames"``: ``llr_t`` is frame-major, a contiguous ``(B, N)``
    int8 tensor, and û comes back ``(B, K)``, with no transpose on the
    card; the u track of the kernels :func:`has_frames` names, on every
    device (``ValueError`` otherwise)."""
    start = profiling.begin()
    n = int(np.asarray(frozen).size)
    if style not in STYLES:
        raise ValueError(f"unknown kernel style {style!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if style == "scratch":
        if want_cw:
            raise ValueError("the cw track requires the SSA kernel style")
        scratch_frames(n)
    by_frame = layout == "frames"
    if by_frame:
        if want_cw or not has_frames(style, n):
            raise ValueError(f"the frame-major layout is the u track of the "
                             f"tile kernels, not style {style!r} at N={n}"
                             f"{' with the cw track' if want_cw else ''}")
        _check_llrs(llr_t, n, frames=True)
    if llr_t.device.type == "cpu":
        if by_frame:
            mesg, _ = decode_plain(program, frozen, llr_t.t(), False)
            return mesg.t().contiguous(), None
        return decode_plain(program, frozen, llr_t, want_cw)
    if llr_t.device.type != "cuda":
        raise ValueError(f"no decoder for device {llr_t.device}")
    if not by_frame:
        _check_llrs(llr_t, n, frames=False)
    k = n - int(np.count_nonzero(frozen))
    b = llr_t.shape[0 if by_frame else 1]
    dev = llr_t.device
    mesg = torch.empty((b, k) if by_frame else (k, b), dtype=torch.int8,
                       device=dev)
    cw = torch.empty((n, b), dtype=torch.int8, device=dev) if want_cw else None
    if b == 0:
        return mesg, cw
    stream = build.stream(dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8),
                                     np.asarray(frozen, np.uint8), dev)
    if by_frame:   # the tile kernel is the scratch entry's (2, 2) shape
        wr, vw, warps = ((2, 2, tile_warps(n, False)) if style == "ssa" else
                         shape or scratch_shape(n.bit_length() - 1, b))
        err = build.load_library().polar_scratch_decode_frames(
            prog_d.data_ptr(), n, k, b, llr_t.data_ptr(), mesg.data_ptr(), wr,
            vw, warps, stream)
        build.check(err, "polar_scratch_decode_frames")
        profiling.launched(start, launches, "fastssc_decoder_u_frames"
                           if style == "ssa" else "scratch_decoder_frames")
        return mesg, None
    if style == "scratch":
        wr, vw, warps = shape or scratch_shape(n.bit_length() - 1, b)
        err = build.load_library().polar_scratch_decode(
            prog_d.data_ptr(), n, b, llr_t.data_ptr(), mesg.data_ptr(), wr, vw,
            warps, int(scratch_aligned(b, vw, (llr_t, mesg))), stream)
        build.check(err, "polar_scratch_decode")
        profiling.launched(start, launches, "scratch_decoder")
        return mesg, None
    track = "cw" if want_cw else "u"
    if style == "ssa" and ssa_kernel(n) == "tile":
        outs = (llr_t, mesg) + ((cw,) if want_cw else ())
        aligned = b % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in outs)
        err = build.load_library().polar_tile_decode(
            prog_d.data_ptr(), llr_t.data_ptr(), mesg.data_ptr(),
            cw.data_ptr() if want_cw else None, n, b, tile_warps(n, want_cw),
            int(aligned), stream)
        build.check(err, "polar_tile_decode")
        profiling.launched(start, launches, f"fastssc_decoder_{track}")
        return mesg, cw
    soft = torch.empty((n, b), dtype=torch.int8, device=dev)
    hard = torch.empty((n, b), dtype=torch.int8, device=dev)
    err = build.load_library().polar_decode(
        prog_d.data_ptr(), frozen_d.data_ptr(), llr_t.data_ptr(),
        soft.data_ptr(), hard.data_ptr(), mesg.data_ptr(),
        cw.data_ptr() if want_cw else None, n, b, THREADS, stream)
    build.check(err, "polar_decode")
    profiling.launched(start, launches, f"walk_decoder_{track}")
    return mesg, cw


# The float kernel (csrc/decoder.cu f32_frames_kernel): W frames a tile,
# one to a word, all W words of a row on one lane (W = 1, 2, 4 are built);
# a tile's shared memory is two regions of n float rows, 8 n bytes a frame.
# The tile by level, from the tile A/B (NVIDIA H100 80GB HBM3, 700 W;
# Polar(2^m, 2^(m-1)), device ms of one decode by CUDA events, the better
# of two readings, warps by _warps_for; tiles 1 / 2 / 4):
#   m    B=4096                    B=32768
#   6    .0266 / .0286 / .0261     .1073 / .0704 / .0521
#   8    .0489 / .0358 / .0340     .3209 / .2020 / .1509
#   9    .0864 / .0619 / .0572     .5584 / .3655 / .3197
#   10   .2059 / .1923 / .1920     1.2901 / 1.0566 / 1.1178
#   11   .5414 / .5370 / .5506     3.7095 / 3.8205 / 3.8964
#   12   1.8069 / 1.8820 / 2.6688  12.8162 / 13.2063 / 21.0505
#   13   6.0503 / 9.2824 / -       -
# (m = 4, 5, 7 as m = 6: tile 4 ahead.) Wide tiles win while a frame's 8 n
# bytes are few, one-frame tiles once they bound the warps an SM holds.


def f32_tile(level: int) -> int:
    """Frames a tile of the float kernel at this level (the A/B above)."""
    return 4 if level <= 9 else 2 if level <= 11 else 1


def f32_tile_bytes(n: int, w: int) -> int:
    """Shared memory of one tile of the float kernel at code length
    ``n``: the soft pyramid and the hard stack, ``w`` float words a row."""
    return 2 * n * 4 * w


F32_MAX_LEVEL = max(m for m in range(1, 20)
                    if f32_tile_bytes(1 << m, f32_tile(m))
                    <= SCRATCH_SMEM_BYTES)   # 14


def decode_f32(program, frozen, llrs):
    """û ``(B, K)`` int8 in {-1, 0, +1} of frame-major ``(B, N)`` float32
    LLRs in float32 min-sum: the float kernel for a CUDA tensor (up to
    level :data:`F32_MAX_LEVEL`, tiles of :func:`f32_tile`'s frames),
    :func:`decode_plain` for a CPU one. Raises
    ``ValueError`` for another dtype, shape or stride, or a level above
    :data:`F32_MAX_LEVEL` on a card."""
    start = profiling.begin()
    n = int(np.asarray(frozen).size)
    if (llrs.dtype != torch.float32 or llrs.ndim != 2 or llrs.shape[1] != n
            or not llrs.is_contiguous()):
        raise ValueError(f"expected contiguous (B, N={n}) float32 LLRs, got "
                         f"{tuple(llrs.shape)} {llrs.dtype}")
    if llrs.device.type == "cpu":
        mesg, _ = decode_plain(program, frozen, llrs.t(), False)
        return mesg.t().contiguous()
    if llrs.device.type != "cuda":
        raise ValueError(f"no decoder for device {llrs.device}")
    if n > 1 << F32_MAX_LEVEL:
        raise ValueError(f"the float kernel keeps 8N bytes a frame in shared "
                         f"memory: N <= {1 << F32_MAX_LEVEL}, not {n}")
    tile = f32_tile(n.bit_length() - 1)
    k = n - int(np.count_nonzero(frozen))
    b = llrs.shape[0]
    mesg = torch.empty((b, k), dtype=torch.int8, device=llrs.device)
    if b == 0:
        return mesg
    stream = build.stream(llrs.device)
    prog_d, _ = device_tables(np.asarray(program, np.uint8),
                              np.asarray(frozen, np.uint8), llrs.device)
    err = build.load_library().polar_f32_decode_frames(
        prog_d.data_ptr(), llrs.data_ptr(), mesg.data_ptr(), n, k, b, tile,
        _warps_for(f32_tile_bytes(n, tile)), stream)
    build.check(err, "polar_f32_decode_frames")
    profiling.launched(start, launches, "f32_decoder_frames")
    return mesg


def plan(program, batch: int, style: str = "ssa", want_cw: bool = False,
         f32: bool = False, layout: str | None = None) -> dict:
    """The launch of the tile kernel that :func:`decode` (``f32``:
    :func:`decode_f32`) runs for ``batch`` frames of the byte program's
    code in ``layout`` (by default the frame-major u track wherever
    :func:`has_frames`, the entries' main path): the kernel, its tile shape
    ``(wr, vw)`` and warps a block, the rows of its register block, and
    the transform and fold stages a tile runs in registers and in shared
    memory (:func:`tile_stages.program_stages`). The walk has no tile:
    ``{"kernel": "walk"}``."""
    level = int(np.asarray(program)[0])
    n = 1 << level
    if layout is None:
        layout = ("frames" if f32 or not want_cw and has_frames(style, n)
                  else "lanes")
    if f32:
        w = f32_tile(level)
        wr, vw, warps = w, w, _warps_for(f32_tile_bytes(n, w))
    elif style == "scratch":
        wr, vw, warps = scratch_shape(level, batch)
    elif style == "ssa" and ssa_kernel(n) == "tile":
        wr, vw, warps = 2, 2, tile_warps(n, want_cw)
    else:
        return {"kernel": "walk"}
    block = tile_stages.block_rows(wr, vw)
    return {"kernel": "f32" if f32 else "tile" if style == "ssa" else style,
            "wr": wr, "vw": vw, "warps": warps, "block_rows": block,
            **tile_stages.program_stages(program, block, want_cw,
                                         folds=layout != "frames")}


def simd_selftest(device) -> dict:
    """Mismatches of each packed function of ``csrc/fastssc_simd.cuh``
    against its scalar namesake in ``csrc/fastssc.cuh``, over all 65,536
    int8 pairs (``madd`` under each hard value -1, 0, +1), by name of
    :data:`SIMD_PRIMITIVES`: all 0 on a sound card. It tests the card's
    intrinsics, so it has no plain version and needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the packed-function self-test runs on a CUDA "
                         f"device, not {device}")
    bad = torch.zeros(len(SIMD_PRIMITIVES), dtype=torch.int32, device=device)
    stream = build.stream(device)
    build.check(build.load_library().polar_simd_selftest(bad.data_ptr(),
                                                         stream),
                "polar_simd_selftest")
    return dict(zip(SIMD_PRIMITIVES, bad.tolist()))
