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
and hat at the info rows, ``(2 N + K) B`` bytes. Its default style,
``"rows"`` (``count_rows_kernel``), reads 16 frames a lane as one 16-byte
word a row, a warp a frame group of 512 frames, on a grid of frame groups
× row chunks (:func:`count_plan`); each CTA writes its group's frame-error
bits for its chunk as 32-bit words and its partial sums into a scratch
array, and the last CTA to finish folds them (an OR over chunks, pop
counts, int64 sums) into the ``(5,)`` int64 result: one launch, no torch
reduction after it. ``style="bytes"`` runs the one-byte-a-thread kernel it
replaced (``count_bytes_kernel``), whose ``(blocks, 5)`` partials the
wrapper sums, kept so that the two can be timed in turns. Both count the
same. :func:`count_rows_twin` writes the default kernel's decomposition
out in torch for the CPU tests; the main path does not use it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import profiling
from . import build
from .decoder_kernel import device_mask
from .step_kernel import COUNTERS, cw_counts

STYLES = ("rows", "bytes")
FRAMES_PER_BLOCK = 32  # csrc/count.cu kFrames (style "bytes")
LANES = 32             # style "bytes": threads sharing one frame's rows
GROUP_FRAMES = 512     # csrc/count.cu kGroupFrames: a warp's frames
LANE_FRAMES = 16       # kLaneFrames: one 16-byte word a row
SUMS = 4               # kSums: a CTA's partial sums (err, amb, awgn, qz)
CTAS_PER_SM = 8        # the grid's aim: CTAs of 8 warps an SM
MIN_CHUNK_ROWS = 256   # a chunk's least rows: 32 a warp
launches = {"count": 0}
# launches of the replaced kernel (style "bytes"), apart from the
# default's, so that a run can show it took the new kernel
earlier_launches = {"count_bytes": 0}
plain_calls = {"count_plain": 0}
_tickets: dict = {}


def count_plain(frozen, llr_t, cw_t, hat_t) -> torch.Tensor:
    """The counters in plain torch (the bool-domain block of
    ``polar_tpu/ber.py:344-359``)."""
    plain_calls["count_plain"] += 1
    frz = torch.as_tensor(np.asarray(frozen, bool), device=llr_t.device)
    return cw_counts(frz.reshape(-1, 1), llr_t, cw_t, hat_t)


def count_plan(n: int, batch: int, sms: int) -> tuple[int, int, int]:
    """``(groups, chunks, rows_per_chunk)`` of the default kernel's grid:
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


def count(frozen, llr_t, cw_t, hat_t, style: str = "rows") -> torch.Tensor:
    """The counters of one step (arguments as :func:`count_plain`): the
    kernel for CUDA tensors, :func:`count_plain` for CPU ones. ``style``
    picks the CUDA kernel (:data:`STYLES`); both count the same, and a CPU
    tensor runs the plain version whatever the style."""
    start = profiling.begin()
    if style not in STYLES:
        raise ValueError(f"count style {style!r} not in {STYLES}")
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
    if style == "bytes":
        blocks = -(-batch // FRAMES_PER_BLOCK)
        out = torch.empty((blocks, len(COUNTERS)), dtype=torch.int32,
                          device=dev)
        err = build.load_library().polar_count(*ptrs, mask, n, batch, LANES,
                                               out.data_ptr(), stream)
        build.check(err, "polar_count")
        profiling.launched(start, earlier_launches, "count_bytes")
        return out.sum(dim=0, dtype=torch.int64)
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
