"""Block-structured large-N Monte-Carlo front on the card: wrappers and
plain versions.

The kernels (``csrc/front.cu``) replace
``polar_tpu/ops/pallas/step_kernel.py:make_pallas_front_blocks`` (``:831``):
kernel A (:func:`msg_blocks`, ``:713-759``) draws ±1 message symbols per
row block, pins the frozen rows and, when systematic, applies the block's
bottom butterfly stages; kernel B (:func:`chan_blocks`, ``:762-778``)
applies the bottom stages of its block, AWGN and quantization. Between
them :func:`middle` runs the top butterfly stages and the systematic
refreeze in plain torch, as the JAX package runs them in XLA
(``:957-970``). The butterfly's stages commute, so any block levels give
the same result.

Two modes, as the fused step's: inject (``msg_t`` ±1 int8 and
``normals_t`` float32, both ``(N, B)``) and native, which draws the fused
step's Philox words (word ``N + r`` for row r's symbol, Box-Muller over
words ``[0, N)`` with row i paired with row N/2 + i), so the large-N step
reproduces the fused step's counters on the same seeds.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version only for CPU ones; :data:`launches` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ...channel import channel_llrs
from ...ops.transform import polar_transform_stages
from . import build, philox
from .decoder_kernel import THREADS, device_mask

# Row-block levels of kernels A and B (rows 2^level per block), cut to the
# code's level for smaller codes. Set from the H100 timings in PERF.md;
# they only move butterfly stages between the kernels and the middle.
BLOCK_LEVEL = 10
CHAN_BLOCK_LEVEL = 10
launches = {"front_blocks_a": 0, "front_blocks_b": 0}
plain_calls = {"msg_blocks_plain": 0, "chan_blocks_plain": 0}


def _check_blk(n: int, blk: int) -> None:
    if blk < 1 or blk & (blk - 1) or n % blk or n // blk > 65535:
        raise ValueError(f"block of {blk} rows does not tile N={n}")


def _check(t, name, shape, dtype, dev):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name}: expected contiguous {shape} {dtype} on "
                         f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def msg_blocks_plain(frozen, blk: int, butterfly: bool, *, msg_t=None,
                     seeds=None, call: int = 0, batch: int = 0, device=None):
    """Kernel A's plain version: (N, B) int8."""
    plain_calls["msg_blocks_plain"] += 1
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    if msg_t is None:
        msg_t = philox.bits_to_sym(philox.random_bits(
            philox.seed_words(seeds), call, n, batch, device, first=n))
    frz = torch.as_tensor(frozen.astype(bool), device=msg_t.device).reshape(n, 1)
    u0 = torch.where(frz, torch.ones_like(msg_t), msg_t)
    return polar_transform_stages(u0, 1, blk, axis=0) if butterfly else u0


def msg_blocks(frozen, blk: int, butterfly: bool, *, msg_t=None, seeds=None,
               call: int = 0, batch: int = 0, device=None):
    """Kernel A: message symbols per ``blk``-row block, frozen rows +1,
    the block's bottom butterfly stages when ``butterfly``. Inject mode
    with ``msg_t`` (N, B) ±1 int8; native mode with ``seeds``, ``call``,
    ``batch`` and ``device``."""
    dev = msg_t.device if msg_t is not None else torch.device(device)
    if dev.type == "cpu":
        return msg_blocks_plain(frozen, blk, butterfly, msg_t=msg_t,
                                seeds=seeds, call=call, batch=batch,
                                device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no front kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    _check_blk(n, blk)
    s0 = s1 = 0
    if msg_t is not None:
        batch = msg_t.shape[1] if msg_t.ndim == 2 else -1
        _check(msg_t, "msg_t", (n, batch), torch.int8, dev)
    else:
        s0, s1 = philox.seed_words(seeds)
    out = torch.empty((n, batch), dtype=torch.int8, device=dev)
    if batch == 0:
        return out
    err = build.load_library().polar_front_msg(
        device_mask(frozen, dev).data_ptr(), n, batch, blk, int(butterfly),
        msg_t.data_ptr() if msg_t is not None else None, s0, s1,
        call & 0xFFFFFFFF, out.data_ptr(), THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "polar_front_msg")
    launches["front_blocks_a"] += 1
    return out


def chan_blocks_plain(y, blk: int, params, *, normals_t=None, seeds=None,
                      call: int = 0):
    """Kernel B's plain version: ``(llr_t, cw_t)``, both (N, B) int8."""
    plain_calls["chan_blocks_plain"] += 1
    n, batch = y.shape
    if normals_t is None:
        normals_t = philox.bits_to_normals(philox.random_bits(
            philox.seed_words(seeds), call, n, batch, y.device))
    cw = polar_transform_stages(y, 1, blk, axis=0)
    sigma, scale = params
    return channel_llrs(cw, normals_t, sigma, scale), cw


def chan_blocks(y, blk: int, params, *, normals_t=None, seeds=None,
                call: int = 0):
    """Kernel B: the bottom butterfly stages of each ``blk``-row block of
    ``y`` (N, B) int8, AWGN and quantization with ``params`` = (σ, 2/σ²).
    Inject mode with ``normals_t`` (N, B) float32; native mode with
    ``seeds`` and ``call``. Returns ``(llr_t, cw_t)``."""
    dev = y.device
    if dev.type == "cpu":
        return chan_blocks_plain(y, blk, params, normals_t=normals_t,
                                 seeds=seeds, call=call)
    if dev.type != "cuda":
        raise ValueError(f"no front kernel for device {dev}")
    n, batch = y.shape
    _check_blk(n, blk)
    _check(y, "y", (n, batch), torch.int8, dev)
    s0 = s1 = 0
    if normals_t is not None:
        _check(normals_t, "normals_t", (n, batch), torch.float32, dev)
    else:
        s0, s1 = philox.seed_words(seeds)
    llr = torch.empty((n, batch), dtype=torch.int8, device=dev)
    cw = torch.empty((n, batch), dtype=torch.int8, device=dev)
    if batch == 0:
        return llr, cw
    sigma, scale = params
    err = build.load_library().polar_front_chan(
        n, batch, blk, sigma, scale, y.data_ptr(),
        normals_t.data_ptr() if normals_t is not None else None, s0, s1,
        call & 0xFFFFFFFF, llr.data_ptr(), cw.data_ptr(), THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "polar_front_chan")
    launches["front_blocks_b"] += 1
    return llr, cw


def middle(x, frozen, blk_a: int, blk_b: int, systematic: bool):
    """The top butterfly stages between the kernels, plain torch on
    element-major int8 (values ±1, products exact). Systematic: the first
    transform's stages from ``blk_a`` up, the refreeze, the second
    transform's stages from ``blk_b`` up; plain: the single transform's
    stages from ``blk_b`` up."""
    n = x.shape[0]
    if systematic:
        x = polar_transform_stages(x, blk_a, n, axis=0)
        frz = torch.as_tensor(np.asarray(frozen, bool), device=x.device)
        x = torch.where(frz.reshape(n, 1), torch.ones_like(x), x)
    return polar_transform_stages(x, blk_b, n, axis=0)


def front_blocks(frozen, params, systematic: bool, *, msg_t=None,
                 normals_t=None, seeds=None, call: int = 0, batch: int = 0,
                 device=None, block_level: int | None = None,
                 chan_block_level: int | None = None):
    """The large-N front: message, encode, AWGN, quantize.

    Returns ``(llr_t, cw_t)`` when ``systematic``, else ``(llr_t, cw_t,
    u0_t)`` with ``u0_t`` the frozen-pinned u-domain message; all (N, B)
    int8. ``params`` = (σ, 2/σ²); inject mode with ``msg_t`` and
    ``normals_t``, native mode with ``seeds``, ``call``, ``batch`` and
    ``device``."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    level = n.bit_length() - 1
    blk_a = 1 << min(BLOCK_LEVEL if block_level is None else block_level,
                     level)
    blk_b = 1 << min(CHAN_BLOCK_LEVEL if chan_block_level is None
                     else chan_block_level, level)
    kw = dict(seeds=seeds, call=call)
    x = msg_blocks(frozen, blk_a, systematic, msg_t=msg_t, batch=batch,
                   device=device, **kw)
    llr, cw = chan_blocks(middle(x, frozen, blk_a, blk_b, systematic), blk_b,
                          params, normals_t=normals_t, **kw)
    return (llr, cw) if systematic else (llr, cw, x)
