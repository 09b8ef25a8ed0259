"""Elementwise channel kernels on the card: wrappers and plain versions.

The kernels (``csrc/channel_grid.cu``) replace
``polar_tpu/ops/pallas/channel_kernel.py``: :func:`symbols` replaces
``make_pallas_symbols`` (``:120``, ``_sym_kernel_native`` / ``_bits``
``:77-86``), random ±1 int8 message symbols; :func:`awgn` replaces
``make_pallas_awgn`` (``:146``, ``_awgn_body`` ``:60``, ``_normals``
``:47``), ``quant(2/σ²·(cw + σ·n))`` with cosine-only Box-Muller normals.
Both work on frame-major ``(rows, cols)`` grids, as the JAX kernels do.

Both kernels are bound by instruction throughput on the card. The
symbols kernel (``symbols_lines_kernel``) takes 16 symbols a thread in
straight-line code on a 2-D grid, four ``PhiloxFrame`` blocks and one
16-byte store. AWGN needs about 100 instructions an element against 2
bytes of device memory, with ``-fmad=false`` keeping the plain version's
rounding; its kernel (``awgn_lines_kernel``) takes 16 elements a thread
in straight-line code on a 2-D grid with no division, computes the Philox
round keys and first round once per frame and one polynomial per normal.
:func:`symbols_lines_twin` writes the symbols kernel's index map out in
torch for the CPU tests; the main path does not use it.

Two modes, as the JAX kernels' ``native`` and ``bits``:

* native — words from Philox (``csrc/philox.cuh``): word c of row f is
  lane c % 4 of ``philox4x32_10(counter=(f, c // 4, call, 0), key=seeds)``
  (:func:`~.philox.frame_words`). A symbol takes word c of the message
  stream; a normal takes words c and cols + c of the noise stream, which
  the caller keys with seeds of its own (the JAX package splits ``kmsg``
  and ``knoise``);
* bits — the words come in as int64 tensors holding values in
  [0, 2^32): the counterpart of the JAX ``bits`` mode, and the way to hold
  the kernels against any other chain on the same words.

Each wrapper launches its kernel for CUDA tensors (or a CUDA ``device``)
and runs its plain version only for CPU ones; :data:`launches` counts the
launches, :data:`plain_calls` the plain runs. The plain versions build
int64 Philox temporaries several times the grid's size, so they run in
chunks of frames of at most :data:`PLAIN_CHUNK` elements; a word depends
only on its frame and column, so chunks are exact.
"""

from __future__ import annotations

import math

import torch

from ...channel import channel_llrs
from ...utils import profiling
from . import build, philox

PLAIN_CHUNK = 1 << 24   # grid elements per chunk of a plain version
launches = {"channel_symbols": 0, "channel_awgn": 0}
plain_calls = {"symbols_plain": 0, "awgn_plain": 0}


def _chunks(rows: int, cols: int):
    step = max(1, PLAIN_CHUNK // max(cols, 1))
    return [(f0, min(step, rows - f0)) for f0 in range(0, rows, step)]


def _check(t, name, shape, dtype, dev):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != dev or t.data_ptr() % 4):
        raise ValueError(f"{name}: expected contiguous, 4-byte aligned {shape} "
                         f"{dtype} on {dev}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def symbols_plain(shape=None, *, words=None, seeds=None, call: int = 0,
                  device=None) -> torch.Tensor:
    """The symbols kernel's plain version: ``(rows, cols)`` ±1 int8."""
    plain_calls["symbols_plain"] += 1
    if words is not None:
        return philox.bits_to_sym(words)
    rows, cols = shape
    s = philox.seed_words(seeds)
    parts = [philox.bits_to_sym(philox.frame_words(s, call, nf, cols, device,
                                                   frame0=f0))
             for f0, nf in _chunks(rows, cols)]
    return (torch.cat(parts) if parts else
            torch.empty((0, cols), dtype=torch.int8, device=device))


def symbols(shape=None, *, words=None, seeds=None, call: int = 0,
            device=None) -> torch.Tensor:
    """Random ±1 int8 symbols: ``(rows, cols)`` = ``shape``. Bits mode
    with ``words`` (rows, cols) int64; native mode with ``shape``,
    ``seeds`` (two words), ``call`` and ``device``. A CPU tensor runs the
    plain version."""
    start = profiling.begin()
    dev = words.device if words is not None else torch.device(device)
    if dev.type == "cpu":
        return symbols_plain(shape, words=words, seeds=seeds, call=call,
                             device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no symbols kernel for device {dev}")
    s0 = s1 = 0
    if words is not None:
        shape = tuple(words.shape)
        if len(shape) != 2:
            raise ValueError(f"words: expected (rows, cols), got {shape}")
        _check(words, "words", shape, torch.int64, dev)
    else:
        s0, s1 = philox.seed_words(seeds)
    rows, cols = shape
    out = torch.empty((rows, cols), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    stream = build.stream(dev)
    wptr = words.data_ptr() if words is not None else None
    straight = cols % 16 == 0 and all(
        p % 16 == 0 for p in (out.data_ptr(), wptr) if p is not None)
    # 2: a warp's 512 columns lie in one row, read together in bits mode
    io = 2 if straight and cols % 512 == 0 else int(straight)
    err = build.load_library().polar_symbols_lines(
        rows, cols, wptr, s0, s1, call & 0xFFFFFFFF, out.data_ptr(), io,
        stream)
    build.check(err, "polar_symbols_lines")
    profiling.launched(start, launches, "channel_symbols")
    return out


def philox_frame_blocks(seeds, call: int, frames, blocks):
    """``philox.cuh:PhiloxFrame`` in torch: Philox block ``blocks`` of the
    streams of ``frames`` (broadcastable int64 tensors), by the split first
    round: the state after round 1 of block 0 is computed once a frame
    (``start``), block b enters round 2 with ``b`` XORed into its first
    word, and the nine rounds left use round keys made once
    (``PhiloxFrame``'s constructor). Returns the four output words."""
    k0, k1 = philox.seed_words(seeds)
    kx = [(k0 + r * philox._W0) & philox._MASK for r in range(10)]
    ky = [(k1 + r * philox._W1) & philox._MASK for r in range(10)]
    zero = torch.zeros_like(frames)
    hi0, lo0 = philox._mulhilo(philox._M0, frames)
    hi1, lo1 = philox._mulhilo(philox._M1, zero + (call & philox._MASK))
    first = (hi1 ^ kx[0], lo1, hi0 ^ ky[0], lo0)      # PhiloxFrame.start
    c0, c1, c2, c3 = first[0] ^ blocks, first[1], first[2], first[3]
    for r in range(1, 10):                            # PhiloxFrame.block
        hi0, lo0 = philox._mulhilo(philox._M0, c0)
        hi1, lo1 = philox._mulhilo(philox._M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ kx[r], lo1, hi0 ^ c3 ^ ky[r], lo0
    return c0, c1, c2, c3


def symbols_lines_twin(shape, *, words=None, seeds=None, call: int = 0):
    """``symbols_lines_kernel``'s index map in torch on the CPU:
    ``(symbols, drawn)``, symbols (rows, cols) ±1 int8 and drawn the
    (rows, cols) int64 words they came from. Thread (frame f, column group
    g) takes columns c = 16 g + i, i < 16, c < cols; native mode reads lane
    i % 4 of :func:`philox_frame_blocks` block 4 g + i // 4, bits mode
    word (f, c) of ``words``; a symbol is ``0x01 | (w & 1) * 0xFE`` as a
    signed byte. Bits mode at cols % 512 == 0 takes the kernel's warp
    exchange (``WARP``): lane l of a warp loads word pair 32 k + l of the
    warp's 512 columns (k < 8), two ballots of their low bits follow, and
    lane L takes bits 8 (L & 3) .. + 7 of ballot L >> 2; drawn then holds
    those low bits."""
    rows, cols = shape if words is None else words.shape
    groups = -(-cols // 16)
    f = torch.arange(rows, dtype=torch.int64)[:, None, None]
    g = torch.arange(groups, dtype=torch.int64)[None, :, None]
    i = torch.arange(16, dtype=torch.int64)[None, None, :]
    c = 16 * g + i                                    # (1, groups, 16)
    live = (c < cols).reshape(-1)
    if words is None:
        blocks = philox_frame_blocks(seeds, call, f, 4 * g + i // 4)
        lanes = torch.stack(torch.broadcast_tensors(*blocks), dim=-1)
        w = torch.gather(lanes, 3, (i % 4).expand(rows, groups, 16)[..., None])
        drawn = w.reshape(rows, -1)[:, live]
    elif cols % 512 == 0:
        # (row, warp, k, lane, even / odd): column 64 k + 2 lane + e
        low = (words & 1).view(rows, cols // 512, 8, 32, 2)
        lane = torch.arange(32, dtype=torch.int64)
        ballots = (low << lane[:, None]).sum(3)        # (row, warp, k, 2)
        mine = ballots[:, :, lane >> 2, :] >> (8 * (lane & 3))[:, None]
        bits = (mine[..., None] >> torch.arange(8)) & 1   # (.., L, e, j)
        drawn = bits.transpose(3, 4).reshape(rows, cols)  # 16 L + 2 j + e
    else:
        drawn = words
    sym = (0x01 | (drawn & 1) * 0xFE).to(torch.uint8).view(torch.int8)
    return sym, drawn


def cos_2pi_one_poly(u: torch.Tensor) -> torch.Tensor:
    """The straight-line kernel's cosine (``philox.cuh:cos_2pi``) in torch:
    the quadrant picks the cosine or the sine coefficients of
    :func:`~.philox.sincos_2pi`, one polynomial is evaluated, and the
    sine's factor φ is a product by φ or by 1 (exact). It writes out the
    kernel's arithmetic so that the CPU tests can hold it equal, bit for
    bit, to ``philox.sincos_2pi(u)[0]``; the plain version does not use
    it."""
    f = philox._f32
    t = 4.0 * u
    k = torch.round(t)
    phi = (t - k) * f(math.pi / 2.0)
    x2 = phi * phi
    ki = k.to(torch.int32)
    swap = (ki & 1) == 1

    def pick(sin_c, cos_c):
        return torch.where(swap, f(sin_c), f(cos_c))

    p = 1.0 + x2 * (pick(-1 / 6, -1 / 2) + x2 * (
        pick(1 / 120, 1 / 24) + x2 * (pick(-1 / 5040, -1 / 720)
                                      + x2 * pick(1 / 362880, 1 / 40320))))
    sign = (1 - ((ki + 1) & 2)).to(torch.float32)
    return sign * (p * torch.where(swap, phi, torch.ones_like(phi)))


def awgn_plain(codeword, params, *, words=None, seeds=None,
               call: int = 0) -> torch.Tensor:
    """The AWGN kernel's plain version: ``(rows, cols)`` int8 LLRs."""
    plain_calls["awgn_plain"] += 1
    sigma, scale = params
    if words is not None:
        return channel_llrs(codeword, philox.bits_to_normals_cos(*words),
                            sigma, scale)
    rows, cols = codeword.shape
    s = philox.seed_words(seeds)
    parts = []
    for f0, nf in _chunks(rows, cols):
        w = philox.frame_words(s, call, nf, 2 * cols, codeword.device,
                               frame0=f0)
        parts.append(channel_llrs(
            codeword[f0:f0 + nf],
            philox.bits_to_normals_cos(w[:, :cols], w[:, cols:]), sigma, scale))
    return torch.cat(parts) if parts else torch.empty_like(codeword)


def awgn(codeword, params, *, words=None, seeds=None,
         call: int = 0) -> torch.Tensor:
    """AWGN and quantization of ``codeword`` ``(rows, cols)`` int8 (±1):
    ``quant(scale · (cw + σ·n))`` with ``params`` = (σ, 2/σ²) as float32
    values. Bits mode with ``words`` = (radius, angle), both (rows, cols)
    int64; native mode with ``seeds`` (two words) and ``call``. A CPU
    tensor runs the plain version."""
    start = profiling.begin()
    dev = codeword.device
    if dev.type == "cpu":
        return awgn_plain(codeword, params, words=words, seeds=seeds,
                          call=call)
    if dev.type != "cuda":
        raise ValueError(f"no AWGN kernel for device {dev}")
    if codeword.ndim != 2:
        raise ValueError(f"codeword: expected (rows, cols), got "
                         f"{tuple(codeword.shape)}")
    shape = tuple(codeword.shape)
    _check(codeword, "codeword", shape, torch.int8, dev)
    s0 = s1 = 0
    if words is not None:
        for name, w in zip(("radius words", "angle words"), words):
            _check(w, name, shape, torch.int64, dev)
    else:
        s0, s1 = philox.seed_words(seeds)
    llr = torch.empty(shape, dtype=torch.int8, device=dev)
    if llr.numel() == 0:
        return llr
    ptrs = [codeword.data_ptr(), llr.data_ptr()]
    wptrs = [w.data_ptr() for w in words] if words is not None else [None, None]
    stream = build.stream(dev)
    sigma, scale = params
    straight = shape[1] % 16 == 0 and all(
        p % 16 == 0 for p in ptrs + [w for w in wptrs if w is not None])
    err = build.load_library().polar_awgn_lines(
        shape[0], shape[1], sigma, scale, ptrs[0], *wptrs, s0, s1,
        call & 0xFFFFFFFF, ptrs[1], int(straight), stream)
    build.check(err, "polar_awgn_lines")
    profiling.launched(start, launches, "channel_awgn")
    return llr
