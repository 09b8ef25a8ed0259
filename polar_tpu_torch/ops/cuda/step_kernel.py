"""Monte-Carlo BER step on the card: the fused step, the whole-block front
and decode+count, with their plain versions.

The kernels (``csrc/step.cu`` over ``csrc/mc.cuh``) replace three kernels
of ``polar_tpu/ops/pallas/step_kernel.py``:

* :func:`step` — ``make_pallas_step`` (``:328``): message, encode, AWGN,
  quantize, Fast-SSC decode and the five testbench counters
  (``testbench.cc:125-192``). Style ``"ssa"`` runs, up to level
  :data:`STEP_TILE_MAX_LEVEL`, the tile step (``tile_step_kernel``, over
  ``csrc/fastssc_simd.cuh``): a warp draws, encodes, quantizes, decodes
  and counts a tile of ``decoder_kernel.WHOLE_FRAMES`` frames, four to a
  32-bit word, the pyramid, the stacks and the root LLRs in shared memory.
  Above it, and at every level under ``style="walk"``, the walk
  (``mc_step_kernel``): one thread a frame over device-memory scratch;
* :func:`front` — ``make_pallas_front`` (``:632``, ``_front_kernel_native``
  ``:611`` / ``_inject`` ``:623``): the step's first half, systematic,
  ``(llr_t, cw_t)`` out. Style ``"rows"`` runs, up to level
  :data:`FRONT_ROWS_MAX_LEVEL`, ``csrc/front.cu`` ``front_rows_kernel``: a
  CTA of :func:`front_rows_warps` warps owns 32 frames as row words in
  shared memory (a row's 32 signs one word), draws, runs both transforms
  with the refreeze as XORs on chip and the channel, as the block front's
  kernels A and B do. Above it, and at every level under
  ``style="thread"``, the thread kernel (``front_whole_kernel``, one
  thread a frame over device memory);
* :func:`decode_count` — ``make_pallas_decode_count`` (``:475``,
  ``_decode_count_kernel`` ``:453``): the second half on ``(llr_t, cw_t)``,
  the decode on the codeword-estimate track fused with the counters.
  Style ``"ssa"`` runs, up to ``decoder_kernel.WHOLE_MAX_LEVEL``, the
  tile kernel (``decode_count_tile_kernel``: the whole-code tile decoder's
  cw track, the root in device memory, then the tile step's packed
  counting and a packed pass over ``llr_t`` and ``cw_t`` for the channel
  counters); above it, and at every level under ``style="walk"``, the walk
  (``decode_count_kernel``).

Three modes for the draws:

* native — the kernel draws its own Philox words from two seed words and a
  call counter (``csrc/philox.cuh``); the front draws the fused step's
  words, so the front plus decode+count counts what the step counts;
* bits (:func:`step` only) — the step's words come in as ``words_t``, a
  ``(2N, B)`` int32 tensor holding the u32 bits (:func:`philox.to_int32`
  stores int64 words so): rows ``[0, N)`` feed the normals (radius rows
  ``[0, N/2)``, angle rows ``[N/2, N)``), rows ``[N, 2N)`` the message, the
  layout of ``make_pallas_step(prng="bits")`` (``:417``,
  ``_step_kernel_bits`` ``:295``) and of the native draw; on the words
  native mode draws, the two modes count the same;
* inject — message symbols and normals come in as ``(N, B)`` tensors, so
  the counters can be compared exactly with any other chain fed the same
  inputs.

Each wrapper launches its kernel for the CUDA device and runs its plain
version (the eager chain: encode, channel, eager decoder, counters) only
for the CPU; in native mode the plain chain draws the same words with
:mod:`.philox`. Counters come back as a ``(5,)`` int64 tensor in
:data:`COUNTERS` order. :data:`launches` counts the launches;
:data:`earlier_launches` those of the front's and decode+count's kernels
that the row-word and tile kernels replaced. :func:`front_rows_twin` and
:func:`count_tile_twin` are torch twins of the two kernels' data flow, for
the CPU tests only.
"""

from __future__ import annotations

import numpy as np
import torch

from ...channel import channel_llrs
from ...ops.transform import polar_transform
from ...utils import profiling
from . import build, front_kernel, philox
from .decoder_kernel import (SCRATCH_SMEM_BYTES, THREADS, WHOLE_FRAMES,
                             decode_plain, device_info, device_mask,
                             device_tables, ssa_kernel, tile_max_level,
                             tile_warps)

COUNTERS = ("uncorrected_errors", "frame_errors", "ambiguity_erasures",
            "awgn_errors", "quantization_erasures")
STEP_STYLES = ("ssa", "walk")
# The tile step keeps a tile's soft pyramid, hard stack, root LLRs and, in
# systematic mode, the cw stack in shared memory, n bytes a frame each
# (decoder_kernel.tile_bytes with root=True; the transmitted codeword or u0
# and the plain mode's message rows stay in device scratch). Its limit is
# the largest level at which one systematic tile fits a block's shared
# memory (12), in both modes; above it the step runs the walk.
STEP_TILE_MAX_LEVEL = tile_max_level(root=True)
DECODE_COUNT_STYLES = ("ssa", "walk")
# The whole front: "rows" (the row-word kernel, the default) or "thread"
# (one thread a frame, the kernel it replaced).
FRONT_STYLES = ("rows", "thread")
# The row-word front's CTA: the N row words of its 32 frames, then
# FRONT_ROWS_STAGE words of LLR staging for each of its 1..FRONT_ROWS_MAX_WARPS
# warps (csrc/front.cu kStage), all in shared memory. FRONT_ROWS_MAX_LEVEL
# is the largest level at which that fits a block's shared memory with the
# most warps and the row words stay within the row-word kernels' limit
# (front_kernel.ROWS_MAX_WORDS): 15. Above it "rows" runs the thread kernel.
FRONT_ROWS_STAGE = 64
FRONT_ROWS_MAX_WARPS = 8
FRONT_ROWS_MAX_LEVEL = max(
    m for m in range(1, 20)
    if (1 << m) <= front_kernel.ROWS_MAX_WORDS and 4 * (
        (1 << m) + FRONT_ROWS_STAGE * FRONT_ROWS_MAX_WARPS)
    <= SCRATCH_SMEM_BYTES)
# Warps a CTA of the row-word front (they share its 32 frames and split its
# rows): FRONT_ROWS_MAX_WARPS, or one a chunk of four pair rows where N/8 is
# fewer. The grid is a CTA a 32-frame column whatever the warps, so more
# warps a CTA only add parallel rows. From the warps A/B (python -m
# polar_tpu_torch.utils.step_ab --front-warps --levels 4-13 --batches
# 4096,32768; NVIDIA H100 80GB HBM3, 700.00 W; ms of one native front, two
# readings, 1 / 2 / 4 / 8 warps, the thread kernel):
#   m = 8,  B = 4096:  .0610 .0365 .0353 .0327 / .0562 .0481 .0334 .0276; 0.2143
#   m = 8,  B = 32768: .0636 .0503 .0491 .0500 / .0628 .0519 .0488 .0505; 0.2220
#   m = 10, B = 4096:  .2042 .1101 .0634 .0499 / .1987 .1059 .0610 .0586; 0.9071
#   m = 10, B = 32768: .2311 .1662 .1535 .1486 / .2230 .1664 .1546 .1502; 1.9338
#   m = 12, B = 4096:  .7567 .3827 .1999 .1204 / .7605 .3884 .2047 .1306; 10.963
#   m = 12, B = 32768: .9010 .6432 .5887 .5496 / .8816 .6385 .5847 .5512; 24.080
#   m = 13, B = 32768: 3.0454 1.7425 1.1787 1.0903 / 3.0241 1.7298 1.1768 1.0791
# 8 warps led or tied (within 3 %) at every level and batch from m = 6, at
# m = 4, 5 (one or two chunks a warp) the launch's own time, 0.03 ms, hides
# the warps.
# Tiles a block of the tile decode+count: decoder_kernel.tile_warps(n,
# True), the whole-code tile decoder's on the cw track, below
# COUNT_BIG_BATCH frames; from it COUNT_BIG_WARPS by level where the A/B
# put another count ahead by more than 1 % (python -m
# polar_tpu_torch.utils.step_ab --count-warps --levels 4-13 --batches
# 4096,32768; NVIDIA H100 80GB HBM3, 700.00 W; ms, the mean of two
# readings, at B = 32768): m = 8 8 tiles .1210 against tile_warps' 2,
# .1353; m = 9 8 tiles .2439 against 1, .2747; m = 10 2 tiles .7129
# against 1, .7434 (4 tiles .7134); at m = 11..13 1 tile led. At B = 4096
# no count led tile_warps' by more than 1 % (m = 9: 2 tiles .0952 against
# .0962).
COUNT_BIG_BATCH = 16384
COUNT_BIG_WARPS = {8: 8, 9: 8, 10: 2}
# "mc_step": the tile step, "walk_step": the walk; "front_whole": the
# row-word front, "decode_count": the tile decode+count
launches = {"mc_step": 0, "walk_step": 0, "front_whole": 0,
            "decode_count": 0}
# launches of the kernels the row-word front and the tile decode+count
# replaced (style "thread" / "walk", and the levels above theirs), apart
# from theirs, so that a run can show which it took
earlier_launches = {"front_whole_thread": 0, "decode_count_walk": 0}
plain_calls = {"step_plain": 0, "front_plain": 0,
               "decode_count_plain": 0}


def _bits_plain(bits):
    """Message symbols (N, B) int8 and normals (N, B) float32 from (2N, B)
    int64 words: words [0, N) feed the normals, words [N, 2N) the
    message."""
    n = bits.shape[0] // 2
    return philox.bits_to_sym(bits[n:]), philox.bits_to_normals(bits[:n])


def _draw_plain(seeds, call, n, batch, device):
    """:func:`_bits_plain` of the Philox words the kernel draws."""
    return _bits_plain(philox.random_bits(seeds, call, 2 * n, batch, device))


def _words_plain(words_t):
    """:func:`_bits_plain` of the bits mode's ``(2N, B)`` int32 words."""
    return _bits_plain(words_t.to(torch.int64) & 0xFFFFFFFF)


def _front_plain(frozen, params, systematic: bool, msg_t, normals_t,
                 seeds, call, batch, device):
    """The front half in torch: ``(llr, cw, u0, frozen rows)``."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    if msg_t is None:
        msg_t, normals_t = _draw_plain(seeds, call, n, batch, device)
    frz = torch.as_tensor(frozen.astype(bool), device=msg_t.device).reshape(n, 1)
    u0 = torch.where(frz, torch.ones_like(msg_t), msg_t)
    cw = polar_transform(u0, axis=0)
    if systematic:
        cw = polar_transform(torch.where(frz, torch.ones_like(cw), cw), axis=0)
    sigma, scale = params
    return channel_llrs(cw, normals_t, sigma, scale), cw, u0, frz


def step_plain(program, frozen, params, systematic: bool, *, msg_t=None,
               normals_t=None, words_t=None, seeds=None, call: int = 0,
               batch: int = 0, device=None) -> torch.Tensor:
    """The eager step: inject mode with ``msg_t`` (N, B) ±1 int8 and
    ``normals_t`` (N, B) float32, bits mode with ``words_t`` (2N, B) int32,
    native mode with ``seeds``, ``call``, ``batch`` and ``device``.
    ``params`` = (σ, 2/σ²) as float32 values."""
    plain_calls["step_plain"] += 1
    frozen = np.asarray(frozen, dtype=np.uint8)
    if words_t is not None:
        msg_t, normals_t = _words_plain(words_t)
    llr, cw, u0, frz = _front_plain(frozen, params, systematic, msg_t,
                                    normals_t, seeds, call, batch, device)
    return counts_plain(program, frozen, systematic, llr, cw, u0, frz)


def counts_plain(program, frozen, systematic: bool, llr, cw, u0, frz):
    """Decode the quantized ``llr`` (N, B) and count against the
    transmitted ``cw`` (systematic) or message ``u0`` (plain): the back
    half of :func:`step_plain`; ``frz`` is the (N, 1) bool frozen mask."""
    u_hat, cw_hat = decode_plain(program, frozen, llr, systematic)
    if systematic:
        return cw_counts(frz, llr, cw, cw_hat)
    idx = torch.as_tensor(np.flatnonzero(frozen == 0), device=llr.device)
    zero_d = u_hat == 0
    err = u_hat != u0[idx]
    awgn = (llr != 0) & ((llr < 0) != (cw < 0))
    return torch.stack([err.sum(), err.any(dim=0).sum(), zero_d.sum(),
                        awgn.sum(), (llr == 0).sum()]).to(torch.int64)


def cw_counts(frz, llr, cw, cw_hat) -> torch.Tensor:
    """The counters in the codeword domain (``polar_tpu/ber.py:344-359``)
    as a ``(5,)`` int64 tensor: the estimate ``cw_hat`` against the
    transmitted ``cw`` at the info rows (the message IS those rows), all
    (N, B); ``frz`` is the (N, 1) bool frozen mask."""
    info = ~frz
    zero_d = (cw_hat == 0) & info
    err = (cw_hat != cw) & info
    awgn = (llr != 0) & ((llr < 0) != (cw < 0))
    return torch.stack([err.sum(), err.any(dim=0).sum(), zero_d.sum(),
                        awgn.sum(), (llr == 0).sum()]).to(torch.int64)


def front_plain(frozen, params, *, msg_t=None, normals_t=None, seeds=None,
                call: int = 0, batch: int = 0, device=None):
    """The systematic front in torch: ``(llr_t, cw_t)``, both (N, B)
    int8; the draws as :func:`step_plain`'s."""
    plain_calls["front_plain"] += 1
    llr, cw, _, _ = _front_plain(frozen, params, True, msg_t, normals_t,
                                 seeds, call, batch, device)
    return llr, cw


def front_rows_warps(n: int) -> int:
    """Warps a CTA of the row-word front at code length ``n``: at most
    :data:`FRONT_ROWS_MAX_WARPS`, at most one a chunk of four pair rows."""
    return max(1, min(FRONT_ROWS_MAX_WARPS, n // 8))


def front_kernel_name(n: int, style: str = "rows") -> str:
    """The kernel :func:`front` launches at code length ``n``: ``"rows"``
    up to :data:`FRONT_ROWS_MAX_LEVEL` in style ``"rows"``, else
    ``"thread"``."""
    if style not in FRONT_STYLES:
        raise ValueError(f"front style {style!r} not in {FRONT_STYLES}")
    return ("rows" if style == "rows" and n <= 1 << FRONT_ROWS_MAX_LEVEL
            else "thread")


def front(frozen, params, *, msg_t=None, normals_t=None, seeds=None,
          call: int = 0, batch: int = 0, device=None, style: str = "rows",
          warps: int | None = None):
    """The systematic front (message, frozen pin, encode, AWGN, quantize)
    of :func:`step`, ``(llr_t, cw_t)`` out: the kernel of ``style`` (by
    :func:`front_kernel_name`) on a CUDA device, :func:`front_plain` on
    the CPU. Arguments as :func:`step`'s; ``warps``: the row-word kernel's
    warps a CTA in place of :func:`front_rows_warps`' (the A/B)."""
    start = profiling.begin()
    kernel = front_kernel_name(np.asarray(frozen).size, style)
    inject = msg_t is not None
    dev = msg_t.device if inject else torch.device(device)
    if dev.type == "cpu":
        return front_plain(frozen, params, msg_t=msg_t, normals_t=normals_t,
                           seeds=seeds, call=call, batch=batch, device=dev)
    frozen, batch, s0, s1 = _check_draws(frozen, msg_t, normals_t, seeds,
                                         batch, dev)
    n = frozen.size
    llr = torch.empty((n, batch), dtype=torch.int8, device=dev)
    cw = torch.empty((n, batch), dtype=torch.int8, device=dev)
    if batch == 0:
        return llr, cw
    stream = build.stream(dev)
    sigma, scale = params
    args = (device_mask(frozen, dev).data_ptr(), n, batch, sigma, scale,
            msg_t.data_ptr() if inject else None,
            normals_t.data_ptr() if inject else None, s0, s1,
            call & 0xFFFFFFFF, llr.data_ptr(), cw.data_ptr())
    if kernel == "thread":
        err = build.load_library().polar_front_whole(*args, THREADS, stream)
        build.check(err, "polar_front_whole")
        profiling.launched(start, earlier_launches, "front_whole_thread")
        return llr, cw
    words = front_kernel._word_io(batch, llr, cw, *(
        (msg_t,) if inject else ()))
    err = build.load_library().polar_front_rows(
        *args, warps or front_rows_warps(n), words, stream)
    build.check(err, "polar_front_rows")
    profiling.launched(start, launches, "front_whole")
    return llr, cw


def decode_count_plain(program, frozen, llr_t, cw_t) -> torch.Tensor:
    """Decode+count in torch: the eager decoder's codeword estimate, then
    the counters against ``cw_t`` (:func:`step_plain`'s systematic
    epilogue)."""
    plain_calls["decode_count_plain"] += 1
    frozen = np.asarray(frozen, dtype=np.uint8)
    _, cw_hat = decode_plain(program, frozen, llr_t, True)
    frz = torch.as_tensor(frozen.astype(bool),
                          device=llr_t.device).reshape(-1, 1)
    return cw_counts(frz, llr_t, cw_t, cw_hat)


def decode_count_warps(n: int, batch: int) -> int:
    """Tiles a block of the tile decode+count at code length ``n`` and
    ``batch`` frames: :data:`COUNT_BIG_WARPS` from
    :data:`COUNT_BIG_BATCH` frames where it lists the level, else
    ``tile_warps(n, True)``."""
    level = n.bit_length() - 1
    if batch >= COUNT_BIG_BATCH and level in COUNT_BIG_WARPS:
        return COUNT_BIG_WARPS[level]
    return tile_warps(n, True)


def decode_count(program, frozen, llr_t, cw_t, style: str = "ssa",
                 warps: int | None = None) -> torch.Tensor:
    """The systematic step's second half on element-major ``(N, B)`` int8
    LLRs and codewords: the decode on the codeword-estimate track and the
    five counters, ``(5,)`` int64. The kernel of ``style`` for CUDA
    tensors (``"ssa"``: the tile kernel up to
    ``decoder_kernel.WHOLE_MAX_LEVEL``, the walk above; ``"walk"``: the
    walk), :func:`decode_count_plain` for CPU ones. ``warps``: the tile
    kernel's tiles a block in place of :func:`decode_count_warps`' (the
    A/B)."""
    start = profiling.begin()
    if style not in DECODE_COUNT_STYLES:
        raise ValueError(f"decode+count style {style!r} not in "
                         f"{DECODE_COUNT_STYLES}")
    dev = llr_t.device
    if dev.type == "cpu":
        return decode_count_plain(program, frozen, llr_t, cw_t)
    if dev.type != "cuda":
        raise ValueError(f"no decode+count kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    k = n - int(np.count_nonzero(frozen))
    batch = llr_t.shape[1] if llr_t.ndim == 2 else -1
    for name, t in (("llr_t", llr_t), ("cw_t", cw_t)):
        if (t.dtype != torch.int8 or tuple(t.shape) != (n, batch)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: expected contiguous ({n}, {batch}) "
                             f"int8 on {dev}, got {tuple(t.shape)} {t.dtype}")
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8), frozen,
                                     dev)
    lib = build.load_library()
    if style == "ssa" and ssa_kernel(n) == "tile":
        warps = warps or decode_count_warps(n, batch)
        tiles = -(-batch // WHOLE_FRAMES)
        out = torch.empty((-(-tiles // warps), len(COUNTERS)),
                          dtype=torch.int32, device=dev)
        aligned = batch % 16 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (llr_t, cw_t))
        err = lib.polar_decode_count_tile(
            prog_d.data_ptr(), device_info(frozen, dev).data_ptr(), n, k,
            batch, llr_t.data_ptr(), cw_t.data_ptr(), out.data_ptr(), warps,
            int(aligned), stream)
        build.check(err, "polar_decode_count_tile")
        profiling.launched(start, launches, "decode_count")
        return out.sum(dim=0, dtype=torch.int64)
    out = torch.empty((-(-batch // THREADS), len(COUNTERS)), dtype=torch.int32,
                      device=dev)
    soft, hard = (torch.empty((n, batch), dtype=torch.int8, device=dev)
                  for _ in range(2))
    mesg = torch.empty((k, batch), dtype=torch.int8, device=dev)
    err = lib.polar_decode_count(
        prog_d.data_ptr(), frozen_d.data_ptr(), n, batch, llr_t.data_ptr(),
        cw_t.data_ptr(), soft.data_ptr(), hard.data_ptr(), mesg.data_ptr(),
        out.data_ptr(), THREADS, stream)
    build.check(err, "polar_decode_count")
    profiling.launched(start, earlier_launches, "decode_count_walk")
    return out.sum(dim=0, dtype=torch.int64)


def _check_draws(frozen, msg_t, normals_t, seeds, batch, dev,
                 words_t=None):
    """Checked kernel arguments of the draws: ``(frozen, batch, seed0,
    seed1)``; raises on a device other than CUDA or a bad inject or bits
    input."""
    if dev.type != "cuda":
        raise ValueError(f"no step kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    if words_t is not None:
        batch = words_t.shape[1] if words_t.ndim == 2 else -1
        if (words_t.dtype != torch.int32
                or tuple(words_t.shape) != (2 * n, batch)
                or not words_t.is_contiguous() or words_t.device != dev):
            raise ValueError(f"words_t: expected contiguous ({2 * n}, {batch})"
                             f" int32 on {dev}")
        return frozen, batch, 0, 0
    if msg_t is None:
        return (frozen, batch) + philox.seed_words(seeds)
    batch = msg_t.shape[1] if msg_t.ndim == 2 else -1
    for name, t, dtype in (("msg_t", msg_t, torch.int8),
                           ("normals_t", normals_t, torch.float32)):
        if (t is None or t.dtype != dtype or tuple(t.shape) != (n, batch)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: expected contiguous ({n}, {batch}) "
                             f"{dtype} on {dev}")
    return frozen, batch, 0, 0


def step_kernel_name(n: int) -> str:
    """The kernel of style ``"ssa"`` at code length ``n``: ``"tile"`` from
    level 2 (its draws take whole 4-row Philox blocks) up to
    :data:`STEP_TILE_MAX_LEVEL`, ``"walk"`` elsewhere."""
    return "tile" if 4 <= n <= 1 << STEP_TILE_MAX_LEVEL else "walk"


def step(program, frozen, params, systematic: bool, *, msg_t=None,
         normals_t=None, words_t=None, seeds=None, call: int = 0,
         batch: int = 0, device=None, style: str = "ssa") -> torch.Tensor:
    """One Monte-Carlo step (arguments as :func:`step_plain`): the kernel
    of ``style`` (``"ssa"``: the tile step up to
    :data:`STEP_TILE_MAX_LEVEL`, the walk above; ``"walk"``: the walk) on a
    CUDA device, :func:`step_plain` on the CPU."""
    start = profiling.begin()
    if style not in STEP_STYLES:
        raise ValueError(f"unknown step style {style!r}")
    inject = msg_t is not None
    dev = (msg_t.device if inject else words_t.device
           if words_t is not None else torch.device(device))
    if dev.type == "cpu":
        return step_plain(program, frozen, params, systematic, msg_t=msg_t,
                          normals_t=normals_t, words_t=words_t, seeds=seeds,
                          call=call, batch=batch, device=dev)
    frozen, batch, s0, s1 = _check_draws(frozen, msg_t, normals_t, seeds,
                                         batch, dev, words_t)
    words = None if words_t is None else words_t.data_ptr()
    n = frozen.size
    k = n - int(np.count_nonzero(frozen))
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8), frozen,
                                     dev)
    sigma, scale = params
    lib = build.load_library()
    if style == "ssa" and step_kernel_name(n) == "tile":
        warps = tile_warps(n, systematic, root=True)
        tiles = -(-batch // WHOLE_FRAMES)
        out = torch.empty((-(-tiles // warps), len(COUNTERS)),
                          dtype=torch.int32, device=dev)
        # the count's reference (cw or u0), the plain mode's message rows
        tx = torch.empty((n, batch), dtype=torch.int8, device=dev)
        mesg = (None if systematic else
                torch.empty((k, batch), dtype=torch.int8, device=dev))
        aligned = batch % 16 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (tx, mesg) if t is not None)
        err = lib.polar_tile_step(
            prog_d.data_ptr(), frozen_d.data_ptr(),
            device_info(frozen, dev).data_ptr(), n, k, batch, int(systematic),
            sigma, scale, msg_t.data_ptr() if inject else None,
            normals_t.data_ptr() if inject else None, words, s0, s1,
            call & 0xFFFFFFFF, tx.data_ptr(),
            None if mesg is None else mesg.data_ptr(), out.data_ptr(), warps,
            int(aligned), stream)
        build.check(err, "polar_tile_step")
        profiling.launched(start, launches, "mc_step")
        return out.sum(dim=0, dtype=torch.int64)
    blocks = -(-batch // THREADS)
    out = torch.empty((blocks, len(COUNTERS)), dtype=torch.int32, device=dev)
    scratch = [torch.empty((n, batch), dtype=torch.int8, device=dev)
               for _ in range(5)]  # u0, cw, llr, soft pyramid, hard stack
    mesg = torch.empty((k, batch), dtype=torch.int8, device=dev)
    err = lib.polar_step(
        prog_d.data_ptr(), frozen_d.data_ptr(), n, batch, int(systematic),
        sigma, scale,
        msg_t.data_ptr() if inject else None,
        normals_t.data_ptr() if inject else None, words,
        s0, s1, call & 0xFFFFFFFF, *(s.data_ptr() for s in scratch),
        mesg.data_ptr(), out.data_ptr(), THREADS, stream)
    build.check(err, "polar_step")
    profiling.launched(start, launches, "walk_step")
    return out.sum(dim=0, dtype=torch.int64)


# -- torch twins of the row-word front's and the tile decode+count's data
# flow, for the CPU tests: the same row words, stages, Philox blocks, word
# stores and packed counting as csrc/front.cu front_rows_kernel and
# csrc/step.cu decode_count_tile_kernel, so that their index math is held
# against the plain versions where the kernels cannot run.

def _staged_llr_words(llr, c: int) -> torch.Tensor:
    """The row-word front's word stores of ``llr`` (N, B), B % 4 == 0: a
    chunk's rows j + t and N/2 + j + t (t < c) staged as 32 bytes a row of
    a 32-frame column, a lane storing frames 4q .. 4q + 3 of a row as one
    little-endian 32-bit word where they are in the batch; returns what the
    stores leave in an (N, B) array."""
    n, b = llr.shape
    h = n // 2
    cols = -(-b // 32)
    padded = torch.zeros((n, 32 * cols), dtype=torch.int8)
    padded[:, :b] = llr.cpu()
    out = torch.zeros((n, b), dtype=torch.int8)
    live = int((4 * torch.arange(8 * cols) < b).sum())   # quads stored
    for j in range(0, h, c):
        rows = [j + t for t in range(c)] + [h + j + t for t in range(c)]
        stage = np.ascontiguousarray(padded[rows].numpy())
        words = stage.view("<u4")         # a lane's word: frames 4q .. 4q + 3
        out[rows] = torch.from_numpy(words.view(np.int8)[:, :4 * live].copy())
    return out.to(llr.device)


def front_rows_twin(frozen, params, *, msg_t=None, normals_t=None,
                    seeds=None, call: int = 0, batch: int = 0, device=None):
    """The row-word front's data flow (``front_rows_kernel``): ``(llr_t,
    cw_t, drawn)``. u0's row words (kernel A's chunked draw of
    :func:`front_kernel.msg_rows_twin` over the whole code, blocks of N
    rows, its first transform as XOR stages), the refreeze of the words,
    the second transform and the channel as kernel B's over one block of N
    rows (:func:`front_kernel.chan_rows_twin`: pair j's Box-Muller gives
    rows j and N/2 + j), the LLRs through the word stores where B % 4 ==
    0 (the wrapper's rule for aligned tensors)."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    x, drawn = front_kernel.msg_rows_twin(
        frozen, n, True, msg_t=msg_t, seeds=seeds, call=call, batch=batch,
        device=device)
    w = front_kernel.row_words(x)
    w[torch.as_tensor(frozen.astype(bool), device=w.device)] = 0
    y = front_kernel.rows_from_words(w, x.shape[1])
    llr, cw = front_kernel.chan_rows_twin(y, n, params, normals_t=normals_t,
                                          seeds=seeds, call=call)
    if llr.shape[1] % 4 == 0:
        llr = _staged_llr_words(llr, min(4, n // 2))
    return llr, cw, drawn


_ONES = 0x01010101


def _bytes(w) -> torch.Tensor:
    """int64 words holding uint32 → their four bytes, (..., 4)."""
    return torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=-1)


def _pack(b) -> torch.Tensor:
    return sum(b[..., k] << (8 * k) for k in range(4))


def _vcmpeq4(a, b) -> torch.Tensor:
    return _pack((_bytes(a) == _bytes(b)).to(torch.int64) * 0xFF)


def _popc(w) -> torch.Tensor:
    return sum((w >> i) & 1 for i in range(32))


def count_tile_twin(program, frozen, llr_t, cw_t, warps: int | None = None):
    """The tile decode+count's counting (``decode_count_tile_kernel``):
    ``(counts (5,) int64, per-block counts (blocks, 5))``. Tiles of 8
    frames as two 32-bit words of four frames a row (frames past the batch
    read 0), byte masks of the live frames; the channel pass over every
    row (zero bytes, bit 7 of llr ^ cw where the LLR is not 0); at each
    info row, lane m mod 32's, the cw track's estimate (the plain
    decoder's) against cw; a frame's errors OR-ed over its lanes; the sums
    per block of ``warps`` tiles (:func:`decode_count_warps`')."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    n, b = llr_t.shape
    _, hat = decode_plain(program, frozen, llr_t, True)
    tiles = -(-b // WHOLE_FRAMES)
    warps = warps or decode_count_warps(n, b)

    def words(x):                          # (n, tiles, 2) packed words
        p = torch.zeros((n, tiles * WHOLE_FRAMES), dtype=torch.int64)
        p[:, :b] = x.cpu().to(torch.int64) & 0xFF
        return _pack(p.view(n, tiles, 2, 4))

    llr, cw, hat = words(llr_t), words(cw_t), words(hat)
    frame = torch.arange(tiles * WHOLE_FRAMES).view(tiles, 2, 4)
    live = _pack((frame < b).to(torch.int64) * 0xFF)          # (tiles, 2)
    zero = torch.zeros((), dtype=torch.int64)
    z = _vcmpeq4(llr, zero) & live
    flips = _popc((llr ^ cw) & ~z & live & 0x80808080).sum(dim=(0, 2))
    zeros = _popc(z & _ONES).sum(dim=(0, 2))
    info = np.flatnonzero(frozen == 0)
    e = ~_vcmpeq4(hat[info], cw[info]) & 0xFFFFFFFF & live
    zd = _vcmpeq4(hat[info], zero) & live
    lane_err = torch.zeros((32, tiles, 2), dtype=torch.int64)
    for m in range(len(info)):                # lane m mod 32's rows
        lane_err[m % 32] |= e[m]
    frame_err = lane_err[0]
    for lane in range(1, 32):
        frame_err = frame_err | lane_err[lane]
    per_tile = torch.stack([
        _popc(e & _ONES).sum(dim=(0, 2)), _popc(frame_err & _ONES).sum(-1),
        _popc(zd & _ONES).sum(dim=(0, 2)), flips, zeros], dim=1)
    blocks = -(-tiles // warps)
    pad = torch.zeros((blocks * warps - tiles, 5), dtype=torch.int64)
    per_block = torch.cat([per_tile, pad]).view(blocks, warps, 5).sum(1)
    return per_block.sum(0), per_block
