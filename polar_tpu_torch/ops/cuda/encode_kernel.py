"""Block polar encoder on the card: wrapper and plain version.

The kernel (``csrc/encode.cu``) replaces
``polar_tpu/ops/pallas/encode_kernel.py:make_pallas_encoder`` (``:63``,
``_block_kernel`` ``:52``): the bottom ``block_level`` butterfly stages of
each row block in on-chip memory, with the systematic refreeze between two
block transforms. The stages commute, so with the top stages P outside
(``encode_kernel.py:1-33``, ``:117-138``)::

    encode(u)            = B(P(scatter(u)))
    encode_systematic(u) = P(B(mask · B(P(scatter(u)))))

On the card a frame's 2^l-row block is 2^l contiguous bytes of the
frame-major ``(B, N)`` layout and sits in shared memory; when the block is
the whole code the kernel scatters the message too, and the encode is one
launch with no torch stages. The JAX block level (13) and frame tile (128)
are VMEM facts and do not carry over; the port takes any batch.

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
from . import build
from .decoder_kernel import device_mask

# Row-block level of the kernel, cut to the code's level, and the largest
# it takes: 2^17 bytes is the largest power of two that fits the 227 KB of
# shared memory a block may take, and on an H100 the fastest (PERF.md).
BLOCK_LEVEL = 17
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


def _device_tables(code: PolarCode, blk: int, dev):
    """(info rows, per-block first info index) as int32 on ``dev``."""
    key = (code.frozen.tobytes(), blk, str(dev))
    if key not in _tables:
        info = np.asarray(code.info_indices, np.int32)
        kstart = np.searchsorted(info, np.arange(0, code.N + 1, blk))
        _tables[key] = (torch.tensor(info, device=dev),
                        torch.tensor(kstart.astype(np.int32), device=dev))
    return _tables[key]


def _encode_cuda(code: PolarCode, message, systematic: bool, blk: int):
    n, k, dev = code.N, code.K, message.device
    batch = message.shape[0] if message.ndim == 2 else -1
    if (message.dtype != torch.int8 or tuple(message.shape) != (batch, k)
            or not message.is_contiguous()):
        raise ValueError(f"message: expected contiguous (B, {k}) int8, got "
                         f"{tuple(message.shape)} {message.dtype}")
    if n // blk > 65535:
        raise ValueError(f"{n // blk} row blocks of {blk}: more than 65535")
    out = torch.empty((batch, n), dtype=torch.int8, device=dev)
    if batch == 0:
        return out
    stream = build.stream(dev)
    whole = blk == n
    x = None if whole else polar_transform_stages(
        _scatter_message(code, message), blk, n).contiguous()
    info, kstart = _device_tables(code, blk, dev)
    words = max(blk // 4, 1)
    threads = min(1024, max(32, -(-words // 2 // 32) * 32))
    err = build.load_library().polar_encode(
        message.data_ptr(), k, info.data_ptr(), kstart.data_ptr(), int(whole),
        x.data_ptr() if x is not None else None,
        device_mask(code.frozen, dev).data_ptr(), n, batch, blk,
        int(systematic), out.data_ptr(), threads, stream)
    build.check(err, "polar_encode")
    launches["block_encoder"] += 1
    if systematic and not whole:
        out = polar_transform_stages(out, blk, n)
    return out


def make_encoder(code: PolarCode, *, systematic: bool = True,
                 block_level: int | None = None):
    """``enc(message)``: ``(B, K)`` ±1 int8 → ``(B, N)`` int8 codeword,
    equal to ``encode`` / ``encode_systematic``. ``block_level``: the
    kernel's row-block level, by default :data:`BLOCK_LEVEL`, cut to the
    code's level."""
    blk = _block(code, block_level)

    def enc(message):
        dev = message.device
        if dev.type == "cpu":
            return encode_plain(code, message, systematic, blk)
        if dev.type != "cuda":
            raise ValueError(f"no encoder kernel for device {dev}")
        return _encode_cuda(code, message, systematic, blk)

    return enc
