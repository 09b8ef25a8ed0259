"""The Monte-Carlo counter epilogue on the card: wrapper and plain version.

The kernel (``csrc/count.cu``) replaces
``polar_tpu/ops/pallas/step_kernel.py:make_pallas_count`` (``:544``,
``_count_kernel`` ``:537``): the five testbench counters over the front's
``(llr_t, cw_t)`` and the decoder's codeword estimate ``hat_t``, all
``(N, B)`` int8, in the cw domain of ``_count_and_store`` (``:182-222``).
:func:`count` launches the kernel for CUDA tensors and runs
:func:`count_plain` only for CPU ones; both return the counters as a
``(5,)`` int64 tensor in ``step_kernel.COUNTERS`` order.

The counter is bound by device memory: it reads llr and cw at every row
and hat at the info rows, ``(2 N + K) B`` bytes. Its kernel
(``count_rows_kernel``) reads 16 frames a lane as one 16-byte word a row, a warp a frame group of 512 frames, on a grid of frame groups
× row chunks (:func:`count_plan`); each CTA writes its group's frame-error
bits for its chunk as 32-bit words and its partial sums into a scratch
array, and the last CTA to finish folds them (an OR over chunks, pop
counts, int64 sums) into the ``(5,)`` int64 result: one launch, no torch
reduction after it. :func:`count_rows_twin` writes the kernel's
decomposition out in torch for the CPU tests; the main path does not use it.

:func:`count_frames` counts the draws path's step in the u domain
(``ber.frame_counters``) over frame-major message and decoded ``(B, K)``
and codeword and LLRs ``(B, N)``: ``count_frames_kernel`` for CUDA
tensors, :func:`count_frames_plain` for CPU ones. It replaces no Pallas
kernel: the JAX package's draws-path counters are jnp
(``polar_tpu/ber.py:394-411``). Its bound is the four tensors read once,
``2 (N + K) B`` bytes; the torch expressions copy each bool mask to int64
before they sum it. The kernel gives each frame a span of lanes (the
least power of two that covers its 16-byte words, at most a warp), uses
the counter's byte-SIMD compares, one ballot a frame unit for the frame
errors, int64 partials a CTA and the last-CTA fold:
:func:`count_frames_plan` sizes it, its grid one resident wave by the
runtime's occupancy of the instance launched (:func:`frame_wave`), and
:func:`count_frames_twin` writes its decomposition out in torch for the
CPU tests. :func:`u_counters` is the one definition of these counters.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import profiling
from . import build
from .decoder_kernel import device_mask
from .step_kernel import COUNTERS, cw_counts

GROUP_FRAMES = 512     # csrc/count.cu kGroupFrames: a warp's frames
LANE_FRAMES = 16       # kLaneFrames: one 16-byte word a row
SUMS = 4               # kSums: a CTA's partial sums (err, amb, awgn, qz)
CTAS_PER_SM = 8        # the grid's aim: CTAs of 8 warps an SM
MIN_CHUNK_ROWS = 256   # a chunk's least rows: 32 a warp
FRAME_WARPS = 8        # csrc/count.cu kFrameWarps: count_frames' CTA
launches = {"count": 0, "count_frames": 0}
plain_calls = {"count_plain": 0, "count_frames_plain": 0}
_tickets: dict = {}
_frame_waves: dict = {}


def count_plain(frozen, llr_t, cw_t, hat_t) -> torch.Tensor:
    """The counters in plain torch (the bool-domain block of
    ``polar_tpu/ber.py:344-359``)."""
    plain_calls["count_plain"] += 1
    frz = torch.as_tensor(np.asarray(frozen, bool), device=llr_t.device)
    return cw_counts(frz.reshape(-1, 1), llr_t, cw_t, hat_t)


def count_plan(n: int, batch: int, sms: int) -> tuple[int, int, int]:
    """``(groups, chunks, rows_per_chunk)`` of the kernel's grid:
    frame groups of :data:`GROUP_FRAMES` × row chunks, about
    :data:`CTAS_PER_SM` CTAs an SM on ``sms`` SMs, each chunk at least
    :data:`MIN_CHUNK_ROWS` rows (but one), at most 65535 chunks."""
    groups = -(-batch // GROUP_FRAMES)
    want = -(-CTAS_PER_SM * sms // groups)
    chunks = max(1, min(want, n // MIN_CHUNK_ROWS, 65535))
    rows = -(-n // chunks)
    return groups, -(-n // rows), rows


def _ticket(dev, stream: int) -> torch.Tensor:
    """The fold's ticket for launches on ``stream``: one int32 word, 0
    between launches (the last CTA resets it), made once per device and
    stream."""
    key = (str(dev), stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _tickets[key]


def count(frozen, llr_t, cw_t, hat_t) -> torch.Tensor:
    """The counters of one step (arguments as :func:`count_plain`): the
    kernel for CUDA tensors, :func:`count_plain` for CPU ones."""
    start = profiling.begin()
    dev = llr_t.device
    if dev.type == "cpu":
        return count_plain(frozen, llr_t, cw_t, hat_t)
    if dev.type != "cuda":
        raise ValueError(f"no count kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    batch = llr_t.shape[1] if llr_t.ndim == 2 else -1
    tensors = (llr_t, cw_t, hat_t)
    for name, t in zip(("llr_t", "cw_t", "hat_t"), tensors):
        if (t.dtype != torch.int8 or tuple(t.shape) != (n, batch)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: expected contiguous ({n}, {batch}) "
                             f"int8 on {dev}, got {tuple(t.shape)} {t.dtype}")
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    ptrs = [t.data_ptr() for t in tensors]
    mask = device_mask(frozen, dev).data_ptr()
    groups, chunks, rows = count_plan(
        n, batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    words = -(-batch // 32)
    scratch = torch.empty(chunks * words + SUMS * groups * chunks,
                          dtype=torch.int32, device=dev)
    out = torch.empty(len(COUNTERS), dtype=torch.int64, device=dev)
    straight = batch % LANE_FRAMES == 0 and all(p % 16 == 0 for p in ptrs)
    err = build.load_library().polar_count_rows(
        *ptrs, mask, n, batch, chunks, rows, int(straight), scratch.data_ptr(),
        _ticket(dev, stream).data_ptr(), out.data_ptr(), stream)
    build.check(err, "polar_count_rows")
    profiling.launched(start, launches, "count")
    return out


def u_counters(message, codeword, llrs, decoded) -> tuple:
    """The five counters of frame-major ``(B, K)`` message and decoded bits
    and ``(B, N)`` codeword and LLRs, as 0-d int64 tensors in ``COUNTERS``
    order, in the bool domain (``polar_tpu/ber.py:394-411``): for
    message/codeword in {-1,+1}, ``decoded*message <= 0`` ⟺
    ``decoded==0 ∨ sign(decoded)≠sign(message)`` and ``llrs*codeword < 0``
    ⟺ ``llrs≠0 ∧ sign(llrs)≠sign(codeword)``. The one definition of the
    draws path's counters: ``ber.frame_counters`` and
    :func:`count_frames_plain` take them from here."""
    zero_d = decoded == 0
    errs = zero_d | ((decoded < 0) != (message < 0))
    return (errs.sum(), errs.any(dim=-1).sum(), zero_d.sum(),
            ((llrs != 0) & ((llrs < 0) != (codeword < 0))).sum(),
            (llrs == 0).sum())


def count_frames_plain(message, codeword, llrs, decoded) -> torch.Tensor:
    """:func:`u_counters` stacked to a ``(5,)`` int64 tensor."""
    plain_calls["count_frames_plain"] += 1
    return torch.stack(u_counters(message, codeword, llrs, decoded))


def count_frames_plan(batch: int, k: int, n: int,
                      resident: int) -> tuple[int, int]:
    """``(span_log2, blocks)`` of ``count_frames_kernel``'s launch: a frame
    spans ``2 ** span_log2`` lanes, the least power of two that covers the
    16-byte words of its longer row, at most a warp; CTAs of
    :data:`FRAME_WARPS` warps, enough for every frame unit (a warp's
    frames) and at most ``resident``, the CTAs of the instance launched
    that the card holds at once (:func:`frame_wave`): one wave, as a
    partial second one leaves SMs idle at its end."""
    words = max(1, -(-max(k, n) // 16))
    span_log2 = min(5, (words - 1).bit_length())
    units = -(-batch // (32 >> span_log2))
    return span_log2, max(1, min(-(-units // FRAME_WARPS), resident))


def frame_wave(dev, straight: bool) -> int:
    """The CTAs of ``count_frames_kernel``'s 16-byte (``straight``) or byte
    instance that ``dev`` holds at once: the occupancy the runtime reports
    for it (its registers set it; six CTAs an SM for the 16-byte one on an
    H100 built here), times the SMs. Asked once a device and instance."""
    key = (str(dev), straight)
    if key not in _frame_waves:
        per_sm = ctypes.c_int(0)
        build.check(build.load_library().polar_count_frames_occupancy(
            int(straight), ctypes.byref(per_sm)),
            "polar_count_frames_occupancy")
        if per_sm.value < 1:
            raise RuntimeError("count_frames_kernel's CTA does not fit an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _frame_waves[key] = per_sm.value * sms
    return _frame_waves[key]


def count_frames(message, codeword, llrs, decoded) -> torch.Tensor:
    """The five counters of frame-major ``(B, K)`` int8 message and
    decoded and ``(B, N)`` int8 codeword and LLRs as a ``(5,)`` int64
    tensor in ``COUNTERS`` order: one ``count_frames_kernel`` launch for
    CUDA tensors, :func:`count_frames_plain` for CPU ones. On a card it
    raises for a dtype, shape, layout or device the kernel does not
    take."""
    start = profiling.begin()
    dev = message.device
    if dev.type == "cpu":
        return count_frames_plain(message, codeword, llrs, decoded)
    if dev.type != "cuda":
        raise ValueError(f"no count_frames kernel for device {dev}")
    batch, k = message.shape if message.ndim == 2 else (-1, -1)
    n = llrs.shape[-1] if llrs.ndim == 2 else -1
    want = {"message": (batch, k), "decoded": (batch, k),
            "codeword": (batch, n), "llrs": (batch, n)}
    tensors = {"message": message, "decoded": decoded, "codeword": codeword,
               "llrs": llrs}
    for name, t in tensors.items():
        if (t.dtype != torch.int8 or t.ndim != 2
                or tuple(t.shape) != want[name] or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name}: expected contiguous {want[name]} int8 "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    ptrs = [t.data_ptr() for t in (message, decoded, codeword, llrs)]
    straight = k % 16 == 0 and n % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    span_log2, blocks = count_frames_plan(batch, k, n,
                                          frame_wave(dev, straight))
    scratch = torch.empty(blocks * len(COUNTERS), dtype=torch.int64,
                          device=dev)
    out = torch.empty(len(COUNTERS), dtype=torch.int64, device=dev)
    err = build.load_library().polar_count_frames(
        *ptrs, batch, k, n, span_log2, blocks, int(straight),
        scratch.data_ptr(), _ticket(dev, stream).data_ptr(), out.data_ptr(),
        stream)
    build.check(err, "polar_count_frames")
    profiling.launched(start, launches, "count_frames")
    return out


# -- a torch twin of count_rows_kernel's decomposition, for the CPU tests:
# the same frame groups, byte words, marks, row chunks, frame-error words
# and fold as csrc/count.cu, so that its index math is held against the
# plain version where the kernel cannot run.

_LOW7, _TOP = 0x7F7F7F7F, 0x80808080
_WORD = 0xFFFFFFFF


def _zero80(x: torch.Tensor) -> torch.Tensor:
    """``count.cu:zero80`` on int64 words in [0, 2^32): 0x80 in every
    zero byte."""
    return ~(((x & _LOW7) + _LOW7) | x | _LOW7) & _WORD


def _marks(x: torch.Tensor) -> torch.Tensor:
    """The number of 0x80 marks in each word (``__popc`` of a mask)."""
    return sum((x >> (8 * k + 7)) & 1 for k in range(4))


def _top_bits(x: torch.Tensor) -> torch.Tensor:
    """``count.cu:top_bits``: bit k = byte k's mark, by one 32-bit
    product."""
    return ((((x >> 7) & 0x01010101) * 0x10204080) & _WORD) >> 28


def _byte_words(t: torch.Tensor, width: int) -> torch.Tensor:
    """(N, B) int8 → (N, width / 4) int64 little-endian byte words, the
    frames past B read as 0x01 (``count.cu:kPad``)."""
    n, b = t.shape
    pad = torch.ones((n, width), dtype=torch.int64)
    pad[:, :b] = t.to(torch.int64) & 0xFF
    v = pad.view(n, width // 4, 4)
    return v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24


def count_rows_twin(frozen, llr_t, cw_t, hat_t, rows_per_chunk: int):
    """``count_rows_kernel``'s data flow in torch on the CPU:
    ``(counters, frame_words)``. Frames go in groups of
    :data:`GROUP_FRAMES` (padded with 0x01 bytes, which count nothing),
    rows in chunks of ``rows_per_chunk``. Per chunk and group: the four
    partial sums (int32 in the kernel) from the byte words' marks (hat
    only at info rows); per chunk the frame-error words, bit j of word w
    for frame 32 w + j, ``ceil(B / 32)`` of them; then the fold: an OR of
    each word over the chunks, pop counts and int64 sums.
    ``frame_words`` is the (chunks, ceil(B / 32)) int64 scratch."""
    frozen = np.asarray(frozen, dtype=bool)
    n, b = llr_t.shape
    groups = -(-b // GROUP_FRAMES)
    width = groups * GROUP_FRAMES
    l, c, h = (_byte_words(t, width) for t in (llr_t, cw_t, hat_t))
    info = torch.as_tensor(~frozen).reshape(n, 1)
    lz = _zero80(l)
    ne = ~_zero80(h ^ c) & _TOP & torch.where(info, _WORD, 0)
    per_word = torch.stack([                         # (N, words, 4)
        _marks(ne),                                  # uncorrected errors
        _marks(_zero80(h)) * info,                   # ambiguity erasures
        _marks((l ^ c) & ~lz & _TOP),                # awgn errors
        _marks(lz)], dim=-1)                         # quantization erasures
    chunks = -(-n // rows_per_chunk)
    words = -(-b // 32)
    partials = torch.zeros((chunks, groups, SUMS), dtype=torch.int64)
    frame_words = torch.zeros((chunks, words), dtype=torch.int64)
    # a row's error mark of frame 4 i + j: bit 8 j + 7 of word i
    marks = torch.stack([(ne >> (8 * j + 7)) & 1 for j in range(4)], dim=-1)
    top = torch.tensor([8 * j + 7 for j in range(4)], dtype=torch.int64)
    for k in range(chunks):
        rows = slice(k * rows_per_chunk, min(n, (k + 1) * rows_per_chunk))
        partials[k] = per_word[rows].sum(0).view(groups, -1, SUMS).sum(1)
        # a lane's OR accumulators: its four words of 0x80 marks
        acc = (marks[rows].amax(0) << top).sum(-1).view(-1, 4)
        bits = (_top_bits(acc) << torch.tensor([0, 4, 8, 12])).sum(-1)
        # lanes 2 j and 2 j + 1 make the group's frame word j
        frame_words[k] = (bits[0::2] | bits[1::2] << 16)[:words]
    any_frame = torch.zeros(words, dtype=torch.int64)
    for k in range(chunks):
        any_frame |= frame_words[k]
    fe = int(sum(((any_frame >> j) & 1).sum() for j in range(32)))
    err, amb, awgn, qz = (int(s) for s in partials.sum((0, 1)))
    return (torch.tensor([err, fe, amb, awgn, qz], dtype=torch.int64),
            frame_words)


# -- a torch twin of count_frames_kernel's decomposition, for the CPU tests:
# the same spans of lanes, 16-byte row words padded with 0x01 bytes, marks,
# ballots, CTAs and fold as csrc/count.cu.


def _row_words(t: torch.Tensor, words: int) -> torch.Tensor:
    """(B, L) int8 → (B, words, 4) int64: each row's 16-byte words as four
    little-endian 32-bit words, the bytes past L read as 0x01
    (``count.cu:row_word``)."""
    b, length = t.shape
    pad = torch.ones((b, 16 * words), dtype=torch.int64)
    pad[:, :length] = t.to(torch.int64) & 0xFF
    v = pad.view(b, words, 4, 4)
    return v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24


def count_frames_twin(message, codeword, llrs, decoded, span_log2: int,
                      blocks: int):
    """``count_frames_kernel``'s data flow in torch on the CPU:
    ``(counters, partials)``. Frame f is frame-unit ``f >> (5 -
    span_log2)``'s, read by lanes ``(f % units_frames) * span ..`` of its
    warp, lane ``sub`` taking the row words ``sub, sub + span, ...``; the
    unit goes to warp ``unit % (blocks * FRAME_WARPS)`` and so to its CTA.
    A lane's four sums come from its words' marks and its any-error flag is
    the OR of its error marks; a unit's ballot sets bit ``lane`` for a lane
    that saw an error, and the span's first lane counts its frame when any
    of the span's bits is set. ``partials`` is the (blocks, 5) int64
    scratch; the counters are its sum."""
    batch, k = message.shape
    n = llrs.shape[1]
    span = 1 << span_log2
    per_warp = 32 >> span_log2
    units = -(-batch // per_warp)
    frames = units * per_warp            # the ragged tail's lanes read nothing
    wk, wn = -(-k // 16), -(-n // 16)

    def words(t, count):
        pad = torch.ones((frames, t.shape[1]), dtype=torch.int8)
        pad[:batch] = t
        return _row_words(pad, count)

    m, d = words(message, wk), words(decoded, wk)
    c, l = words(codeword, wn), words(llrs, wn)
    live = (torch.arange(frames) < batch).reshape(-1, 1, 1)
    dz = _zero80(d)
    e = (dz | ((d ^ m) & _TOP)) * live
    lz = _zero80(l)
    lane_k = torch.arange(wk) % span        # the lane of each row word
    lane_n = torch.arange(wn) % span

    def by_lane(x, lane):
        """(frames, words, 4) marks → (frames, span) marks a lane."""
        per_word = _marks(x).sum(-1)
        out = torch.zeros((frames, span), dtype=torch.int64)
        return out.index_add_(1, lane, per_word)

    sums = [by_lane(e, lane_k), by_lane(dz * live, lane_k),
            by_lane(((l ^ c) & ~lz & _TOP) * live, lane_n),
            by_lane(lz * live, lane_n)]
    seen = torch.zeros((frames, span), dtype=torch.int64)
    seen.index_add_(1, lane_k, (e != 0).any(-1).long())
    # the ballot of each unit: bit (f % per_warp) * span + sub
    bit = torch.arange(32, dtype=torch.int64)
    hit = ((seen.reshape(units, 32) > 0).long() << bit).sum(-1)
    seg = (1 << span) - 1
    first = bit[::span]
    # (units, per_warp): each span's first lane tests the span's bits
    fe = (((hit.reshape(-1, 1) >> first) & seg) != 0).long()
    cta = (torch.arange(units) % (blocks * FRAME_WARPS)) // FRAME_WARPS
    per_unit = torch.stack([
        sums[0].reshape(units, -1).sum(-1), fe.sum(-1),
        sums[1].reshape(units, -1).sum(-1),
        sums[2].reshape(units, -1).sum(-1),
        sums[3].reshape(units, -1).sum(-1)], dim=-1)
    partials = torch.zeros((blocks, len(COUNTERS)), dtype=torch.int64)
    partials.index_add_(0, cta, per_unit)
    return partials.sum(0), partials
