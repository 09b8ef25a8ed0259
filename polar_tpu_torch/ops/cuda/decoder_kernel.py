"""Whole-code Fast-SSC decoder on the card: wrapper and plain version.

The kernel (``csrc/decoder.cu`` over ``csrc/fastssc.cuh``) replaces
``polar_tpu/ops/pallas/decoder_kernel.py``'s ``_ssa_decoder_kernel`` (u
track) and ``_ssa_decoder_kernel_cw`` (codeword-estimate track): one
thread per frame walks the code's byte program over element-major
``(N, B)`` int8 LLRs and writes û ``(K, B)`` and, on the cw track, the
codeword estimate ``(N, B)`` = ``encode(code, û)``.

:func:`decode` launches the kernel for a CUDA tensor and runs
:func:`decode_plain` (the eager decoder) only for a CPU tensor; it keeps
a count of its launches per track in :data:`launches`.
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
launches = {"fastssc_decoder_u": 0, "fastssc_decoder_cw": 0}
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


def decode(program, frozen, llr_t, want_cw: bool):
    """Decode element-major ``(N, B)`` int8 LLRs: the kernel for a CUDA
    tensor, :func:`decode_plain` for a CPU one.

    ``program`` is ``compile_program(code)`` and ``frozen`` the code's
    mask, both numpy uint8. Returns ``(u (K, B), cw (N, B) or None)``."""
    if llr_t.device.type == "cpu":
        return decode_plain(program, frozen, llr_t, want_cw)
    if llr_t.device.type != "cuda":
        raise ValueError(f"no decoder for device {llr_t.device}")
    n = int(np.asarray(frozen).size)
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
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8),
                                     np.asarray(frozen, np.uint8), dev)
    soft = torch.empty((n, b), dtype=torch.int8, device=dev)
    hard = torch.empty((n, b), dtype=torch.int8, device=dev)
    lib = build.load_library()
    err = lib.polar_decode(
        prog_d.data_ptr(), frozen_d.data_ptr(), llr_t.data_ptr(),
        soft.data_ptr(), hard.data_ptr(), mesg.data_ptr(),
        cw.data_ptr() if want_cw else None, n, b, THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "polar_decode")
    launches["fastssc_decoder_cw" if want_cw else "fastssc_decoder_u"] += 1
    return mesg, cw
