"""Fused Monte-Carlo BER step on the card: wrapper and plain version.

The kernel (``csrc/step.cu``) replaces
``polar_tpu/ops/pallas/step_kernel.py:make_pallas_step``: message, encode,
AWGN, quantize, Fast-SSC decode and the five testbench counters
(``testbench.cc:125-192``) in one thread per frame. Two modes:

* native — the kernel draws its own Philox words from two seed words and a
  call counter (``csrc/philox.cuh``);
* inject — message symbols and normals come in as ``(N, B)`` tensors, so
  the counters can be compared exactly with any other chain fed the same
  inputs.

:func:`step` launches the kernel for the CUDA device and runs
:func:`step_plain` (the eager chain: encode, channel, eager decoder,
counters) only for the CPU; in native mode the plain chain draws the same
words with :mod:`.philox`. Both return the counters as a ``(5,)`` int64
tensor in :data:`COUNTERS` order.
"""

from __future__ import annotations

import numpy as np
import torch

from ...channel import channel_llrs
from ...ops.transform import polar_transform
from . import build, philox
from .decoder_kernel import THREADS, decode_plain, device_tables

COUNTERS = ("uncorrected_errors", "frame_errors", "ambiguity_erasures",
            "awgn_errors", "quantization_erasures")
launches = {"mc_step": 0}
plain_calls = {"step_plain": 0}


def _draw_plain(seeds, call, n, batch, device):
    """Message symbols (N, B) int8 and normals (N, B) float32 from the
    Philox words the kernel draws: words [0, N) feed the normals, words
    [N, 2N) the message."""
    bits = philox.random_bits(seeds, call, 2 * n, batch, device)
    return philox.bits_to_sym(bits[n:]), philox.bits_to_normals(bits[:n])


def step_plain(program, frozen, params, systematic: bool, *, msg_t=None,
               normals_t=None, seeds=None, call: int = 0, batch: int = 0,
               device=None) -> torch.Tensor:
    """The eager step: inject mode with ``msg_t`` (N, B) ±1 int8 and
    ``normals_t`` (N, B) float32, native mode with ``seeds``, ``call``,
    ``batch`` and ``device``. ``params`` = (σ, 2/σ²) as float32 values."""
    plain_calls["step_plain"] += 1
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    if msg_t is None:
        msg_t, normals_t = _draw_plain(seeds, call, n, batch, device)
    dev = msg_t.device
    frz = torch.as_tensor(frozen.astype(bool), device=dev).reshape(n, 1)
    info = ~frz
    u0 = torch.where(frz, torch.ones_like(msg_t), msg_t)
    cw = polar_transform(u0, axis=0)
    if systematic:
        cw = polar_transform(torch.where(frz, torch.ones_like(cw), cw), axis=0)
    sigma, scale = params
    llr = channel_llrs(cw, normals_t, sigma, scale)
    u_hat, cw_hat = decode_plain(program, frozen, llr, systematic)
    if systematic:
        zero_d = (cw_hat == 0) & info
        err = (cw_hat != cw) & info
    else:
        idx = torch.as_tensor(np.flatnonzero(frozen == 0), device=dev)
        zero_d = u_hat == 0
        err = u_hat != u0[idx]
    awgn = (llr != 0) & ((llr < 0) != (cw < 0))
    return torch.stack([err.sum(), err.any(dim=0).sum(), zero_d.sum(),
                        awgn.sum(), (llr == 0).sum()]).to(torch.int64)


def step(program, frozen, params, systematic: bool, *, msg_t=None,
         normals_t=None, seeds=None, call: int = 0, batch: int = 0,
         device=None) -> torch.Tensor:
    """One Monte-Carlo step (arguments as :func:`step_plain`): the kernel
    on a CUDA device, :func:`step_plain` on the CPU."""
    inject = msg_t is not None
    dev = msg_t.device if inject else torch.device(device)
    if dev.type == "cpu":
        return step_plain(program, frozen, params, systematic, msg_t=msg_t,
                          normals_t=normals_t, seeds=seeds, call=call,
                          batch=batch, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no step kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    k = n - int(np.count_nonzero(frozen))
    if inject:
        batch = msg_t.shape[1]
        for name, t, dtype in (("msg_t", msg_t, torch.int8),
                               ("normals_t", normals_t, torch.float32)):
            if (t.dtype != dtype or tuple(t.shape) != (n, batch)
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"{name}: expected contiguous ({n}, {batch}) "
                                 f"{dtype} on {dev}")
        s0 = s1 = 0
    else:
        s0, s1 = philox.seed_words(seeds)
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    blocks = -(-batch // THREADS)
    out = torch.empty((blocks, len(COUNTERS)), dtype=torch.int32, device=dev)
    prog_d, frozen_d = device_tables(np.asarray(program, np.uint8), frozen,
                                     dev)
    scratch = [torch.empty((n, batch), dtype=torch.int8, device=dev)
               for _ in range(5)]  # u0, cw, llr, soft pyramid, hard stack
    mesg = torch.empty((k, batch), dtype=torch.int8, device=dev)
    sigma, scale = params
    lib = build.load_library()
    err = lib.polar_step(
        prog_d.data_ptr(), frozen_d.data_ptr(), n, batch, int(systematic),
        sigma, scale,
        msg_t.data_ptr() if inject else None,
        normals_t.data_ptr() if inject else None,
        s0, s1, call & 0xFFFFFFFF, *(s.data_ptr() for s in scratch),
        mesg.data_ptr(), out.data_ptr(), THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "polar_step")
    launches["mc_step"] += 1
    return out.sum(dim=0, dtype=torch.int64)
