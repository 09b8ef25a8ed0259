"""Block-structured large-N Monte-Carlo front on the card: wrappers and
plain versions.

The kernels (``csrc/front.cu``) replace
``polar_tpu/ops/pallas/step_kernel.py:make_pallas_front_blocks`` (``:831``):
kernel A (:func:`msg_blocks`, ``:713-759``) draws ±1 message symbols per
row block, pins the frozen rows and, when systematic, applies the block's
bottom butterfly stages; kernel B (:func:`chan_blocks`, ``:762-778``)
applies the bottom stages of its block, AWGN and quantization. Between
them the middle runs the top butterfly stages and the systematic
refreeze: :func:`middle_kernel` (``_stages_kernel``, ``:800``, with the
refreeze in the same pass) or :func:`middle_plain` in torch, as the JAX
package's ``middle_mode="xla"`` runs them (``:957-970``). The butterfly's
stages commute, so any block levels give the same result.

Two modes, as the fused step's: inject (``msg_t`` ±1 int8 and
``normals_t`` float32, both ``(N, B)``) and native, which draws the fused
step's Philox words (word ``N + r`` for row r's symbol, Box-Muller over
words ``[0, N)`` with row i paired with row N/2 + i), so the large-N step
reproduces the fused step's counters on the same seeds.

Kernels A and B hold 32 frames a row word: a row's ±1 values for a
warp's 32 frames are one 32-bit word made by a warp ballot (bit set for
−1), the block's butterfly runs on those words in shared memory as XORs,
each lane keeps its frame's Philox keys for the whole CTA, kernel A draws
no Philox block for four frozen rows, and kernel B pairs row block R
below N/2 with its partner above, so that each Box-Muller pair is drawn
once for both of its rows. :func:`msg_rows_twin`, :func:`chan_rows_twin`
and the helpers above them are torch twins of the row-word kernels' data
flow (row words, the XOR butterfly, kernel A's Philox blocks with the
frozen skip, kernel B's pairing plan), for the CPU tests only.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version only for CPU ones; :data:`launches` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ...channel import channel_llrs
from ...ops.transform import polar_transform_stages
from ...utils import profiling
from . import build, philox
from .decoder_kernel import THREADS, device_mask

# Row-block levels of kernels A and B (rows 2^level per block), cut to the
# code's level for smaller codes. Set from the H100 timings in PERF.md;
# they only move butterfly stages between the kernels and the middle.
BLOCK_LEVEL = 10
CHAN_BLOCK_LEVEL = 10
# front_blocks runs the middle kernel unless asked for the torch middle:
# the kernel was faster at every level measured (python -m
# polar_tpu_torch.utils.step_ab, B = 4096, systematic, NVIDIA H100 80GB
# HBM3, 700 W): 0.027 against 0.048 ms at m = 6, 0.471 against 28.510 ms
# at m = 17.
MIDDLE_MODES = ("kernel", "torch")
# The middle kernel's window: a thread holds 2^MIDDLE_MAX_LOG rows of four
# frames as bits (csrc/front.cu takes at most 8); more stages take more
# passes.
MIDDLE_MAX_LOG = 8
# Row words a CTA of the row-word kernels holds in shared memory (128 KB):
# kernel A's block, kernel B's two paired blocks.
ROWS_MAX_WORDS = 1 << 15
launches = {"front_blocks_a": 0, "front_blocks_b": 0, "front_middle": 0}
plain_calls = {"msg_blocks_plain": 0, "chan_blocks_plain": 0,
               "middle_plain": 0}
_frozen_bits: dict = {}


def _check_blk(n: int, blk: int) -> None:
    if blk < 1 or blk & (blk - 1) or n % blk or n // blk > 65535:
        raise ValueError(f"block of {blk} rows does not tile N={n}")


def _rows_words(n: int, blk: int, chan: bool) -> int:
    """Row words a CTA of the row-word kernel holds; raises above
    :data:`ROWS_MAX_WORDS`."""
    s = 2 * min(blk, n // 2) if chan else blk
    if s > ROWS_MAX_WORDS:
        raise ValueError(f"a block of {blk} rows puts {s} row words on one "
                         f"CTA, more than {ROWS_MAX_WORDS}: take a lower "
                         "block level")
    return s


def _word_io(batch: int, *tensors) -> int:
    """1 where a lane can move four frames as one 32-bit word."""
    return int(batch % 4 == 0 and all(t.data_ptr() % 4 == 0 for t in tensors))


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
        msg_t = philox.bits_to_sym(philox.frame_words(
            philox.seed_words(seeds), call, batch, n, device, first=n).t()
            .contiguous())
    frz = torch.as_tensor(frozen.astype(bool), device=msg_t.device).reshape(n, 1)
    u0 = torch.where(frz, torch.ones_like(msg_t), msg_t)
    return polar_transform_stages(u0, 1, blk, axis=0) if butterfly else u0


def msg_blocks(frozen, blk: int, butterfly: bool, *, msg_t=None, seeds=None,
               call: int = 0, batch: int = 0, device=None):
    """Kernel A: message symbols per ``blk``-row block, frozen rows +1,
    the block's bottom butterfly stages when ``butterfly``. Inject mode
    with ``msg_t`` (N, B) ±1 int8; native mode with ``seeds``, ``call``,
    ``batch`` and ``device``. A CPU tensor runs the plain version."""
    start = profiling.begin()
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
    _rows_words(n, blk, chan=False)
    s0 = s1 = 0
    if msg_t is not None:
        batch = msg_t.shape[1] if msg_t.ndim == 2 else -1
        _check(msg_t, "msg_t", (n, batch), torch.int8, dev)
    else:
        s0, s1 = philox.seed_words(seeds)
    out = torch.empty((n, batch), dtype=torch.int8, device=dev)
    if batch == 0:
        return out
    stream = build.stream(dev)
    args = (device_mask(frozen, dev).data_ptr(), n, batch, blk,
            int(butterfly), msg_t.data_ptr() if msg_t is not None else None,
            s0, s1, call & 0xFFFFFFFF, out.data_ptr())
    words = _word_io(batch, out, *(() if msg_t is None else (msg_t,)))
    err = build.load_library().polar_front_msg_rows(*args, words, stream)
    build.check(err, "polar_front_msg_rows")
    profiling.launched(start, launches, "front_blocks_a")
    return out


def chan_blocks_plain(y, blk: int, params, *, normals_t=None, seeds=None,
                      call: int = 0):
    """Kernel B's plain version: ``(llr_t, cw_t)``, both (N, B) int8."""
    plain_calls["chan_blocks_plain"] += 1
    n, batch = y.shape
    if normals_t is None:
        normals_t = philox.bits_to_normals(philox.frame_words(
            philox.seed_words(seeds), call, batch, n, y.device).t()
            .contiguous())
    cw = polar_transform_stages(y, 1, blk, axis=0)
    sigma, scale = params
    return channel_llrs(cw, normals_t, sigma, scale), cw


def chan_blocks(y, blk: int, params, *, normals_t=None, seeds=None,
                call: int = 0):
    """Kernel B: the bottom butterfly stages of each ``blk``-row block of
    ``y`` (N, B) int8 ±1, AWGN and quantization with ``params`` = (σ,
    2/σ²). Inject mode with ``normals_t`` (N, B) float32; native mode with
    ``seeds`` and ``call``. A CPU tensor runs the plain version. Returns
    ``(llr_t, cw_t)``."""
    start = profiling.begin()
    dev = y.device
    if dev.type == "cpu":
        return chan_blocks_plain(y, blk, params, normals_t=normals_t,
                                 seeds=seeds, call=call)
    if dev.type != "cuda":
        raise ValueError(f"no front kernel for device {dev}")
    n, batch = y.shape
    _check_blk(n, blk)
    _rows_words(n, blk, chan=True)
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
    stream = build.stream(dev)
    sigma, scale = params
    args = (n, batch, blk, sigma, scale, y.data_ptr(),
            normals_t.data_ptr() if normals_t is not None else None, s0, s1,
            call & 0xFFFFFFFF, llr.data_ptr(), cw.data_ptr())
    err = build.load_library().polar_front_chan_rows(
        *args, _word_io(batch, y, cw), stream)
    build.check(err, "polar_front_chan_rows")
    profiling.launched(start, launches, "front_blocks_b")
    return llr, cw


def middle_plain(x, frozen, blk_a: int, blk_b: int, systematic: bool):
    """The top butterfly stages between the kernels, plain torch on
    element-major int8 (values ±1, products exact). Systematic: the first
    transform's stages from ``blk_a`` up, the refreeze, the second
    transform's stages from ``blk_b`` up; plain: the single transform's
    stages from ``blk_b`` up."""
    plain_calls["middle_plain"] += 1
    n = x.shape[0]
    if systematic:
        x = polar_transform_stages(x, blk_a, n, axis=0)
        frz = torch.as_tensor(np.asarray(frozen, bool), device=x.device)
        x = torch.where(frz.reshape(n, 1), torch.ones_like(x), x)
    return polar_transform_stages(x, blk_b, n, axis=0)


def middle_passes(n: int, blk_a: int, blk_b: int, systematic: bool,
                  max_log: int = MIDDLE_MAX_LOG) -> list:
    """The middle kernel's passes: ``(lo, glog, s1, refreeze, s2)`` each,
    a window of ``2^glog`` rows at stride ``2^lo`` (butterfly stages
    ``2^lo <= h < 2^(lo + glog)``), running the window's stages ``s1 =
    (from, to)`` of the first transform, the refreeze, then ``s2`` of the
    second (stage s of the window is h = 2^(lo + s)).

    The top window, ``glog <= max_log`` stages up to N, holds the
    refreeze; the first transform's stages below it run in passes before
    it, the second's after it. At m = 17 with row blocks of 2^10 the whole
    middle is the top pass. An empty list when there is nothing to do
    (plain, ``blk_b == n``)."""
    m = n.bit_length() - 1
    lb = blk_b.bit_length() - 1
    la = blk_a.bit_length() - 1 if systematic else m
    if not systematic and lb == m:
        return []
    top = max(m - max_log, min(la, lb))
    passes = [(lo, min(max_log, top - lo), (0, min(max_log, top - lo)),
               False, (0, 0)) for lo in range(la, top, max_log)]
    passes.append((top, m - top, (max(la, top) - top, m - top), systematic,
                   (max(lb, top) - top, m - top)))
    passes += [(lo, min(max_log, top - lo), (0, 0), False,
                (0, min(max_log, top - lo))) for lo in range(lb, top, max_log)]
    return passes


def _frozen_words(frozen: np.ndarray, lo: int, glog: int, device):
    """(2^lo, W) int32 words of frozen bits for the top pass: bit j of
    residue r's row is frozen[r + j 2^lo], W = max(1, 2^glog / 32)."""
    key = (frozen.tobytes(), lo, glog, str(device))
    if key not in _frozen_bits:
        g = 1 << glog
        bits = frozen.astype(bool).reshape(g, 1 << lo).T      # (h_lo, G)
        bits = np.pad(bits, ((0, 0), (0, max(32, g) - g)))
        words = np.ascontiguousarray(
            np.packbits(bits, axis=1, bitorder="little")).view("<i4")
        _frozen_bits[key] = torch.tensor(words, device=device)
    return _frozen_bits[key]


def middle_kernel(x, frozen, blk_a: int, blk_b: int, systematic: bool):
    """The middle on the card (arguments and result as
    :func:`middle_plain`; ``x`` must hold ±1): one launch per pass of
    :func:`middle_passes`, each element read and written once per pass.
    The first pass writes a new array, later ones update it in place;
    ``x`` itself is never changed (it is the plain front's ``u0``). With
    no pass to run (plain, ``blk_b == N``) it returns ``x``. On a CPU
    tensor :func:`middle_plain` runs. The launches count once a pass,
    under one span."""
    start = profiling.begin()
    if x.device.type == "cpu":
        return middle_plain(x, frozen, blk_a, blk_b, systematic)
    if x.device.type != "cuda":
        raise ValueError(f"no front kernel for device {x.device}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    batch = x.shape[1] if x.ndim == 2 else -1
    _check(x, "x", (n, batch), torch.int8, x.device)
    _check_blk(n, blk_a)
    _check_blk(n, blk_b)
    passes = middle_passes(n, blk_a, blk_b, systematic)
    if not passes or batch == 0:
        return x
    stream = build.stream(x.device)
    out = torch.empty_like(x)
    words = int(batch % 4 == 0 and x.data_ptr() % 4 == 0)
    lib = build.load_library()
    src = x
    for lo, glog, s1, refreeze, s2 in passes:
        frz = _frozen_words(frozen, lo, glog, x.device) if refreeze else None
        err = lib.polar_front_middle(
            src.data_ptr(), out.data_ptr(),
            frz.data_ptr() if refreeze else None, n, batch, words, 1 << lo,
            glog, *s1, int(refreeze), *s2, THREADS, stream)
        build.check(err, "polar_front_middle")
        src = out
    profiling.launched(start, launches, "front_middle", len(passes))
    return out


def front_blocks(frozen, params, systematic: bool, *, msg_t=None,
                 normals_t=None, seeds=None, call: int = 0, batch: int = 0,
                 device=None, block_level: int | None = None,
                 chan_block_level: int | None = None,
                 middle_mode: str = "kernel"):
    """The large-N front: message, encode, AWGN, quantize.

    Returns ``(llr_t, cw_t)`` when ``systematic``, else ``(llr_t, cw_t,
    u0_t)`` with ``u0_t`` the frozen-pinned u-domain message; all (N, B)
    int8. ``params`` = (σ, 2/σ²); inject mode with ``msg_t`` and
    ``normals_t``, native mode with ``seeds``, ``call``, ``batch`` and
    ``device``. ``middle_mode``: ``"kernel"`` (:func:`middle_kernel`) or
    ``"torch"`` (:func:`middle_plain`, the JAX package's ``"xla"``); the
    same result in either mode."""
    if middle_mode not in MIDDLE_MODES:
        raise ValueError(f"unknown middle_mode {middle_mode!r}")
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
    mid = middle_kernel if middle_mode == "kernel" else middle_plain
    llr, cw = chan_blocks(mid(x, frozen, blk_a, blk_b, systematic), blk_b,
                          params, normals_t=normals_t, **kw)
    return (llr, cw) if systematic else (llr, cw, x)


# -- torch twins of the row-word kernels' data flow, for the CPU tests: the
# same row words, stages, Philox blocks and pairing as csrc/front.cu, in
# torch, so that their index math is held against the plain versions where
# the kernels cannot run.

def row_words(x_t) -> torch.Tensor:
    """(N, B) ±1 int8 → (N, ⌈B/32⌉) int64 row words: bit l of word g is
    frame 32 g + l, set for −1 (a warp's ballot of ``x < 0``); the lanes
    past B vote 0."""
    n, b = x_t.shape
    g = -(-b // 32)
    bits = torch.zeros((n, 32 * g), dtype=torch.int64, device=x_t.device)
    bits[:, :b] = (x_t < 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x_t.device)
    return (bits.view(n, g, 32) << shifts).sum(-1)


def rows_from_words(words, batch: int) -> torch.Tensor:
    """Row words → (N, batch) ±1 int8 (bit set → −1), as a lane stores
    them."""
    n = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(n, -1)[:, :batch]
    return (1 - 2 * bits).to(torch.int8)


def xor_stages(words, blk: int) -> torch.Tensor:
    """The bottom butterfly stages h < ``blk`` of every ``blk``-row block
    on row words: ``word[j] ^= word[j + h]``, the ±1 product as an XOR."""
    n = words.shape[0]
    w = words.clone()
    h = 1
    while h < blk:
        v = w.view(n // (2 * h), 2, h, -1)
        v[:, 0] ^= v[:, 1]
        h *= 2
    return w


def _philox_blocks(seeds, call: int, batch: int, blocks, device):
    """(len(blocks), batch, 4) int64: Philox block ``blocks[i]`` of every
    frame's stream (the words ``4 blocks[i] ..``)."""
    frame = torch.arange(batch, dtype=torch.int64, device=device)[None, :]
    blk = torch.as_tensor(blocks, dtype=torch.int64, device=device)[:, None]
    shape = (blk.shape[0], batch)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    out = philox.philox4x32_10(frame.expand(shape), blk.expand(shape),
                               zero + (call & 0xFFFFFFFF), zero,
                               philox.seed_words(seeds))
    return torch.stack([w.expand(shape) for w in out], dim=2)


def msg_rows_twin(frozen, blk: int, butterfly: bool, *, msg_t=None,
                  seeds=None, call: int = 0, batch: int = 0, device=None):
    """Kernel A's data flow (``front_msg_rows_kernel``): ``(out, drawn)``,
    out (N, B) int8 ±1 and drawn the Philox blocks a frame drew. Rows go
    in chunks of ``c = min(4, blk)`` from each block's start; a chunk draws
    one block, words ``N + r ..`` (block ``(N + r) >> 2``, lanes from
    ``(N + r) & 3``), unless all its rows are frozen; its row words are the
    ballots of the words' low bits on the info rows; the block's XOR
    stages follow when ``butterfly``."""
    frozen = np.asarray(frozen, dtype=bool)
    n = frozen.size
    dev = msg_t.device if msg_t is not None else torch.device(device)
    info = torch.as_tensor(~frozen, device=dev).reshape(n, 1)
    drawn = 0
    if msg_t is not None:
        batch = msg_t.shape[1]
        bits = (msg_t < 0) & info
    else:
        c = min(4, blk)
        starts = np.arange(0, n, c)
        live = ~frozen.reshape(-1, c).all(axis=1)
        drawn = int(live.sum())
        w = n + starts[live]
        v = _philox_blocks(seeds, call, batch, w >> 2, dev)   # (L, B, 4)
        rows = torch.as_tensor(starts[live][:, None] + np.arange(c),
                               device=dev)                    # (L, c)
        lanes = torch.as_tensor((w & 3)[:, None] + np.arange(c), device=dev)
        words = torch.gather(v, 2, lanes[:, None, :].expand(-1, batch, -1))
        bits = torch.zeros((n, batch), dtype=torch.bool, device=dev)
        bits[rows.reshape(-1)] = (words & 1).bool().permute(0, 2, 1).reshape(
            -1, batch)
        bits &= info
    sym = torch.where(bits, -1, 1).to(torch.int8)
    words = row_words(sym)
    if butterfly:
        words = xor_stages(words, blk)
    return rows_from_words(words, batch), drawn


def chan_pair_plan(n: int, blk: int) -> torch.Tensor:
    """Kernel B's CTAs: (N / S, S) int64, row l of CTA p at ``plan[p, l]``.
    P = min(blk, N/2) pair rows a CTA, S = 2 P: pair rows [p P, p P + P)
    below N/2, then the same rows + N/2 (with blk = N the code in order)."""
    h = n // 2
    p_rows = min(blk, h)
    low = torch.arange(0, h, dtype=torch.int64).view(-1, p_rows)
    return torch.cat([low, low + h], dim=1)


def chan_rows_twin(y, blk: int, params, *, normals_t=None, seeds=None,
                   call: int = 0):
    """Kernel B's data flow (``front_chan_rows_kernel``): ``(llr_t,
    cw_t)``. Each CTA of :func:`chan_pair_plan` runs the XOR stages
    below ``blk`` on its S row words; pair rows go in chunks of ``c =
    min(4, P)``, each drawing the radius block ``j >> 2`` and the angle
    block ``(N/2 + j) >> 2`` (the same block where both lie in it); pair
    j's Box-Muller gives row j's normal (n0) and row N/2 + j's (n1)."""
    n, batch = y.shape
    h = n // 2
    plan = chan_pair_plan(n, blk).to(y.device)
    c_rows, s = plan.shape
    cta = xor_stages(row_words(y)[plan.reshape(-1)], blk)
    words = torch.empty_like(cta)
    words[plan.reshape(-1)] = cta
    cw = rows_from_words(words, batch)
    if normals_t is None:
        p_rows = s // 2
        c = min(4, p_rows)
        j = plan[:, :p_rows].reshape(-1, c)[:, 0].cpu().numpy()   # chunks
        vr = _philox_blocks(seeds, call, batch, j >> 2, y.device)
        same = torch.as_tensor((h + j) >> 2 == j >> 2, device=y.device)
        va = torch.where(same[:, None, None], vr, _philox_blocks(
            seeds, call, batch, (h + j) >> 2, y.device))
        off = np.arange(c)
        radius = torch.gather(vr, 2, torch.as_tensor(
            (j[:, None] + off) & 3, device=y.device)[:, None, :].expand(
                -1, batch, -1))
        angle = torch.gather(va, 2, torch.as_tensor(
            (h + j[:, None] + off) & 3, device=y.device)[:, None, :].expand(
                -1, batch, -1))
        pair = torch.as_tensor(j[:, None] + off, device=y.device).reshape(-1)
        rad = torch.empty((h, batch), dtype=torch.int64, device=y.device)
        ang = torch.empty_like(rad)
        rad[pair] = radius.permute(0, 2, 1).reshape(-1, batch)
        ang[pair] = angle.permute(0, 2, 1).reshape(-1, batch)
        n01 = philox.bits_to_normals(torch.cat([rad, ang]))   # n0 | n1
        normals_t = torch.empty((n, batch), dtype=torch.float32,
                                device=y.device)
        normals_t[pair] = n01[pair]
        normals_t[pair + h] = n01[pair + h]
    sigma, scale = params
    return channel_llrs(cw, normals_t, sigma, scale), cw
