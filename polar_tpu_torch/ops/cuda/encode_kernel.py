"""Block polar encoder on the card: wrapper and plain version.

The kernel (``csrc/encode.cu``) replaces
``polar_tpu/ops/pallas/encode_kernel.py:make_pallas_encoder`` (``:63``,
``_block_kernel`` ``:52``): the bottom ``block_level`` butterfly stages of
each row block in on-chip memory, with the systematic refreeze between two
block transforms. The stages commute, so with the top stages P outside
(``encode_kernel.py:1-33``, ``:117-138``)::

    encode(u)            = B(P(scatter(u)))
    encode_systematic(u) = P(B(mask · B(P(scatter(u)))))

On the card the kernel is bound by device memory: the message in once,
the codeword out once. Its kernel (``encode_bits_kernel``) holds one
bit a row (+1 → 0, −1 → 1, so the
butterfly's product is XOR), 32 rows a word: a frame's 2^l-row block is
spread over up to 256 threads, the stages run inside words, across lanes
(shuffles), across registers and, only across warps, through shared
memory; rows are packed on load and unpacked on store 32 bytes a thread.
When the block is the whole code the kernel scatters the message too,
each word from its run of message bytes by the host tables of
:func:`bit_tables`, and the encode is one launch with no torch stages.
The JAX block level (13) and frame tile (128) are
VMEM facts and do not carry over; the port takes any batch.

:func:`make_encoder` returns ``enc(message)``, which launches the kernel
for a CUDA tensor and runs :func:`encode_plain` (the same algebra in
torch) only for a CPU one. Both are bit-exact with
:func:`~polar_tpu_torch.encode.encode` / ``encode_systematic`` on ±1
messages, the encoders' contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ...code.construction import PolarCode
from ...encode import _scatter_message
from ...ops.transform import polar_transform_stages
from ...utils import profiling
from . import build

# Row-block level of the kernel, cut to the code's level, and the largest
# it takes: a 2^17-row block is 16 words a thread over 256 threads.
BLOCK_LEVEL = 17
BIT_THREADS = 256   # threads of a thread block (encode.cu kBitThreads)
launches = {"block_encoder": 0}
plain_calls = {"encode_plain": 0}
_tables: dict = {}


def _block(code: PolarCode, block_level: int | None) -> int:
    level = min(BLOCK_LEVEL if block_level is None else block_level,
                code.level)
    if not 1 <= level <= BLOCK_LEVEL:
        raise ValueError(f"block level {level} outside 1..{BLOCK_LEVEL}")
    return 1 << level


def encode_plain(code: PolarCode, message, systematic: bool, blk: int):
    """The kernel's algebra in torch: scatter, the top stages from ``blk``
    up, the bottom stages (twice around the refreeze when systematic),
    then the top stages again when systematic. ``(B, K)`` → ``(B, N)``."""
    plain_calls["encode_plain"] += 1
    n = code.N
    x = polar_transform_stages(_scatter_message(code, message), blk, n)
    x = polar_transform_stages(x, 1, blk)
    if systematic:
        frz = torch.as_tensor(np.asarray(code.frozen, bool),
                              device=message.device)
        x = polar_transform_stages(torch.where(frz, torch.ones_like(x), x),
                                   1, blk)
        x = polar_transform_stages(x, blk, n)
    return x


def bit_layout(blk: int) -> tuple[int, int, int, int]:
    """(u, words, threads, regs) of the kernel for a ``blk``-row block:
    u rows a word (32, or the block when smaller), ``words`` = blk / u
    words a frame block, spread over ``threads`` (a power of two, at most
    :data:`BIT_THREADS`) holding ``regs`` words each, word i·threads + t
    in thread t's register i."""
    u = min(32, blk)
    words = blk // u
    threads = min(words, BIT_THREADS)
    return u, words, threads, words // threads


def bit_tables(code: PolarCode, blk: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's host tables for row blocks of ``blk`` rows, one
    entry per u-row word of the code (u = min(32, blk)): ``imask``
    (uint32), bit j set when row u·w + j is an info row (the scatter's
    deposit mask and the refreeze's AND), and ``kfirst`` (int32), the index
    of the word's first message symbol (the info rows below it)."""
    u = min(32, blk)
    info = ~np.asarray(code.frozen, bool).reshape(-1, u)
    imask = (info.astype(np.uint64) << np.arange(u, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)
    kfirst = np.concatenate([[0], np.cumsum(info.sum(axis=1))[:-1]])
    return imask, kfirst.astype(np.int32)


def _device_bit_tables(code: PolarCode, blk: int, dev):
    key = ("bits", code.frozen.tobytes(), min(32, blk), str(dev))
    if key not in _tables:
        imask, kfirst = bit_tables(code, blk)
        _tables[key] = (torch.tensor(imask.view(np.int32), device=dev),
                        torch.tensor(kfirst, device=dev))
    return _tables[key]


def _encode_cuda(code: PolarCode, message, systematic: bool, blk: int):
    start = profiling.begin()
    n, k, dev = code.N, code.K, message.device
    batch = message.shape[0] if message.ndim == 2 else -1
    if (message.dtype != torch.int8 or tuple(message.shape) != (batch, k)
            or not message.is_contiguous()):
        raise ValueError(f"message: expected contiguous (B, {k}) int8, got "
                         f"{tuple(message.shape)} {message.dtype}")
    out = torch.empty((batch, n), dtype=torch.int8, device=dev)
    if batch == 0:
        return out
    whole = blk == n
    x = None if whole else polar_transform_stages(
        _scatter_message(code, message), blk, n).contiguous()
    stream = build.stream(dev)
    imask, kfirst = _device_bit_tables(code, blk, dev)
    vec = all(t.data_ptr() % 16 == 0 for t in (out, x) if t is not None)
    err = build.load_library().polar_encode_bits(
        message.data_ptr(), k, imask.data_ptr(), kfirst.data_ptr(),
        int(whole), x.data_ptr() if x is not None else None, n, batch, blk,
        int(systematic), int(vec), out.data_ptr(), stream)
    build.check(err, "polar_encode_bits")
    profiling.launched(start, launches, "block_encoder")
    if systematic and not whole:
        out = polar_transform_stages(out, blk, n)
    return out


def make_encoder(code: PolarCode, *, systematic: bool = True,
                 block_level: int | None = None):
    """``enc(message)``: ``(B, K)`` ±1 int8 → ``(B, N)`` int8 codeword,
    equal to ``encode`` / ``encode_systematic``. ``block_level``: the
    kernel's row-block level, by default :data:`BLOCK_LEVEL`, cut to the
    code's level. A CPU message runs the plain version."""
    blk = _block(code, block_level)

    def enc(message):
        dev = message.device
        if dev.type == "cpu":
            return encode_plain(code, message, systematic, blk)
        if dev.type != "cuda":
            raise ValueError(f"no encoder kernel for device {dev}")
        return _encode_cuda(code, message, systematic, blk)

    return enc
