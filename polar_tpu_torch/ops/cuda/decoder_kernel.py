"""Whole-code Fast-SSC decoder on the card: wrapper and plain version.

Two kernels, two styles of ``polar_tpu/ops/pallas/decoder_kernel.py``'s
``make_pallas_decoder``:

* ``"ssa"`` (``csrc/decoder.cu`` over ``csrc/fastssc.cuh``) replaces
  ``_ssa_decoder_kernel`` (u track) and ``_ssa_decoder_kernel_cw``
  (codeword-estimate track): one thread per frame walks the code's byte
  program over element-major ``(N, B)`` int8 LLRs and writes û ``(K, B)``
  and, on the cw track, the codeword estimate ``(N, B)`` =
  ``encode(code, û)``; its pyramid and hard stack lie in device memory;
* ``"scratch"`` (``csrc/scratch.cu``) replaces ``_decoder_kernel``
  (``:541``), u track only: the same walk with the pyramid and the hard
  stack of a block's frames in shared memory, 2N bytes a frame, so N is at
  most 2^:data:`SCRATCH_MAX_LEVEL` (:func:`scratch_frames` raises above).

:func:`decode` launches the kernel for a CUDA tensor and runs
:func:`decode_plain` (the eager decoder) only for a CPU tensor; it keeps
a count of its launches per kernel in :data:`launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...code.compiler import build_tree, emit_program
from ...code.construction import PolarCode
from ...decode.fastssc import make_fastssc_decoder
from . import build

# Frames (threads) per block for both kernels. On an H100 at Polar(1024, 512)
# 128 was as fast as or faster than 64 at B = 4096, 32768 and 131072; 256
# was faster still at B = 32768 but a third slower at B = 4096 (PERF.md).
THREADS = 128
STYLES = ("ssa", "scratch")
# The scratch style's shared memory: a block may take 227 KB on an H100, and
# holds a multiple of 32 frames (at most 128), 2N bytes each.
SCRATCH_SMEM_BYTES = 232448
SCRATCH_MAX_FRAMES = 128
SCRATCH_MAX_LEVEL = (SCRATCH_SMEM_BYTES // (2 * 32)).bit_length() - 1   # 11
launches = {"fastssc_decoder_u": 0, "fastssc_decoder_cw": 0,
            "scratch_decoder": 0}
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


def decode(program, frozen, llr_t, want_cw: bool, style: str = "ssa"):
    """Decode element-major ``(N, B)`` int8 LLRs: the kernel of ``style``
    for a CUDA tensor, :func:`decode_plain` for a CPU one.

    ``program`` is ``compile_program(code)`` and ``frozen`` the code's
    mask, both numpy uint8. Returns ``(u (K, B), cw (N, B) or None)``.
    ``style="scratch"`` takes the u track only and N <= 2^11, on every
    device."""
    n = int(np.asarray(frozen).size)
    if style not in STYLES:
        raise ValueError(f"unknown kernel style {style!r}")
    if style == "scratch":
        if want_cw:
            raise ValueError("the cw track requires the SSA kernel style")
        frames = scratch_frames(n)
    if llr_t.device.type == "cpu":
        return decode_plain(program, frozen, llr_t, want_cw)
    if llr_t.device.type != "cuda":
        raise ValueError(f"no decoder for device {llr_t.device}")
    k = n - int(np.count_nonzero(frozen))
    if (llr_t.dtype != torch.int8 or llr_t.ndim != 2 or llr_t.shape[0] != n
            or not llr_t.is_contiguous()):
        raise ValueError(f"expected contiguous (N={n}, B) int8 LLRs, got "
                         f"{tuple(llr_t.shape)} {llr_t.dtype}")
    b = llr_t.shape[1]
    dev = llr_t.device
    mesg = torch.empty((k, b), dtype=torch.int8, device=dev)
    cw = torch.empty((n, b), dtype=torch.int8, device=dev) if want_cw else None
    if b == 0:
        return mesg, cw
    stream = build.stream(dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8),
                                     np.asarray(frozen, np.uint8), dev)
    if style == "scratch":
        err = build.load_library().polar_scratch_decode(
            prog_d.data_ptr(), n, b, llr_t.data_ptr(), mesg.data_ptr(), frames,
            stream)
        build.check(err, "polar_scratch_decode")
        launches["scratch_decoder"] += 1
        return mesg, None
    soft = torch.empty((n, b), dtype=torch.int8, device=dev)
    hard = torch.empty((n, b), dtype=torch.int8, device=dev)
    lib = build.load_library()
    err = lib.polar_decode(
        prog_d.data_ptr(), frozen_d.data_ptr(), llr_t.data_ptr(),
        soft.data_ptr(), hard.data_ptr(), mesg.data_ptr(),
        cw.data_ptr() if want_cw else None, n, b, THREADS, stream)
    build.check(err, "polar_decode")
    launches["fastssc_decoder_cw" if want_cw else "fastssc_decoder_u"] += 1
    return mesg, cw
