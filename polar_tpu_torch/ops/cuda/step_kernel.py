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
  ``(llr_t, cw_t)`` out;
* :func:`decode_count` — ``make_pallas_decode_count`` (``:475``,
  ``_decode_count_kernel`` ``:453``): the second half on ``(llr_t, cw_t)``,
  the decode on the codeword-estimate track fused with the counters.

Two modes for the draws:

* native — the kernel draws its own Philox words from two seed words and a
  call counter (``csrc/philox.cuh``); the front draws the fused step's
  words, so the front plus decode+count counts what the step counts;
* inject — message symbols and normals come in as ``(N, B)`` tensors, so
  the counters can be compared exactly with any other chain fed the same
  inputs.

Each wrapper launches its kernel for the CUDA device and runs its plain
version (the eager chain: encode, channel, eager decoder, counters) only
for the CPU; in native mode the plain chain draws the same words with
:mod:`.philox`. Counters come back as a ``(5,)`` int64 tensor in
:data:`COUNTERS` order. :data:`launches` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ...channel import channel_llrs
from ...ops.transform import polar_transform
from . import build, philox
from .decoder_kernel import (THREADS, WHOLE_FRAMES, decode_plain,
                             device_info, device_mask, device_tables,
                             tile_max_level, tile_warps)

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
# "mc_step": the tile step, "walk_step": the walk
launches = {"mc_step": 0, "walk_step": 0, "front_whole": 0,
            "decode_count": 0}
plain_calls = {"step_plain": 0, "front_plain": 0,
               "decode_count_plain": 0}


def _draw_plain(seeds, call, n, batch, device):
    """Message symbols (N, B) int8 and normals (N, B) float32 from the
    Philox words the kernel draws: words [0, N) feed the normals, words
    [N, 2N) the message."""
    bits = philox.random_bits(seeds, call, 2 * n, batch, device)
    return philox.bits_to_sym(bits[n:]), philox.bits_to_normals(bits[:n])


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
               normals_t=None, seeds=None, call: int = 0, batch: int = 0,
               device=None) -> torch.Tensor:
    """The eager step: inject mode with ``msg_t`` (N, B) ±1 int8 and
    ``normals_t`` (N, B) float32, native mode with ``seeds``, ``call``,
    ``batch`` and ``device``. ``params`` = (σ, 2/σ²) as float32 values."""
    plain_calls["step_plain"] += 1
    frozen = np.asarray(frozen, dtype=np.uint8)
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


def front(frozen, params, *, msg_t=None, normals_t=None, seeds=None,
          call: int = 0, batch: int = 0, device=None):
    """The systematic front (message, frozen pin, encode, AWGN, quantize)
    of :func:`step`, ``(llr_t, cw_t)`` out: the kernel on a CUDA device,
    :func:`front_plain` on the CPU. Arguments as :func:`step`'s."""
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
    err = build.load_library().polar_front_whole(
        device_mask(frozen, dev).data_ptr(), n, batch, sigma, scale,
        msg_t.data_ptr() if inject else None,
        normals_t.data_ptr() if inject else None, s0, s1, call & 0xFFFFFFFF,
        llr.data_ptr(), cw.data_ptr(), THREADS, stream)
    build.check(err, "polar_front_whole")
    launches["front_whole"] += 1
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


def decode_count(program, frozen, llr_t, cw_t) -> torch.Tensor:
    """The systematic step's second half on element-major ``(N, B)`` int8
    LLRs and codewords: the decode on the codeword-estimate track and the
    five counters, ``(5,)`` int64. The kernel for CUDA tensors,
    :func:`decode_count_plain` for CPU ones."""
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
    out = torch.empty((-(-batch // THREADS), len(COUNTERS)), dtype=torch.int32,
                      device=dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8), frozen,
                                     dev)
    soft, hard = (torch.empty((n, batch), dtype=torch.int8, device=dev)
                  for _ in range(2))
    mesg = torch.empty((k, batch), dtype=torch.int8, device=dev)
    err = build.load_library().polar_decode_count(
        prog_d.data_ptr(), frozen_d.data_ptr(), n, batch, llr_t.data_ptr(),
        cw_t.data_ptr(), soft.data_ptr(), hard.data_ptr(), mesg.data_ptr(),
        out.data_ptr(), THREADS, stream)
    build.check(err, "polar_decode_count")
    launches["decode_count"] += 1
    return out.sum(dim=0, dtype=torch.int64)


def _check_draws(frozen, msg_t, normals_t, seeds, batch, dev):
    """Checked kernel arguments of the draws: ``(frozen, batch, seed0,
    seed1)``; raises on a device other than CUDA or a bad inject input."""
    if dev.type != "cuda":
        raise ValueError(f"no step kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
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
         normals_t=None, seeds=None, call: int = 0, batch: int = 0,
         device=None, style: str = "ssa") -> torch.Tensor:
    """One Monte-Carlo step (arguments as :func:`step_plain`): the kernel
    of ``style`` (``"ssa"``: the tile step up to
    :data:`STEP_TILE_MAX_LEVEL`, the walk above; ``"walk"``: the walk) on a
    CUDA device, :func:`step_plain` on the CPU."""
    if style not in STEP_STYLES:
        raise ValueError(f"unknown step style {style!r}")
    inject = msg_t is not None
    dev = msg_t.device if inject else torch.device(device)
    if dev.type == "cpu":
        return step_plain(program, frozen, params, systematic, msg_t=msg_t,
                          normals_t=normals_t, seeds=seeds, call=call,
                          batch=batch, device=dev)
    frozen, batch, s0, s1 = _check_draws(frozen, msg_t, normals_t, seeds,
                                         batch, dev)
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
            normals_t.data_ptr() if inject else None, s0, s1,
            call & 0xFFFFFFFF, tx.data_ptr(),
            None if mesg is None else mesg.data_ptr(), out.data_ptr(), warps,
            int(aligned), stream)
        build.check(err, "polar_tile_step")
        launches["mc_step"] += 1
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
        normals_t.data_ptr() if inject else None,
        s0, s1, call & 0xFFFFFFFF, *(s.data_ptr() for s in scratch),
        mesg.data_ptr(), out.data_ptr(), THREADS, stream)
    build.check(err, "polar_step")
    launches["walk_step"] += 1
    return out.sum(dim=0, dtype=torch.int64)
