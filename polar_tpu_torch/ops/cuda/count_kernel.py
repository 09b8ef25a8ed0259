"""The Monte-Carlo counter epilogue on the card: wrapper and plain version.

The kernel (``csrc/count.cu``) replaces
``polar_tpu/ops/pallas/step_kernel.py:make_pallas_count`` (``:544``,
``_count_kernel`` ``:537``): the five testbench counters over the front's
``(llr_t, cw_t)`` and the decoder's codeword estimate ``hat_t``, all
``(N, B)`` int8, in the cw domain of ``_count_and_store`` (``:182-222``).
:func:`count` launches the kernel for CUDA tensors and runs
:func:`count_plain` only for CPU ones; both return the counters as a
``(5,)`` int64 tensor in ``step_kernel.COUNTERS`` order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .decoder_kernel import device_mask
from .step_kernel import COUNTERS, cw_counts

FRAMES_PER_BLOCK = 32  # csrc/count.cu kFrames
LANES = 32             # threads sharing one frame's rows
launches = {"count": 0}
plain_calls = {"count_plain": 0}


def count_plain(frozen, llr_t, cw_t, hat_t) -> torch.Tensor:
    """The counters in plain torch (the bool-domain block of
    ``polar_tpu/ber.py:344-359``)."""
    plain_calls["count_plain"] += 1
    frz = torch.as_tensor(np.asarray(frozen, bool), device=llr_t.device)
    return cw_counts(frz.reshape(-1, 1), llr_t, cw_t, hat_t)


def count(frozen, llr_t, cw_t, hat_t) -> torch.Tensor:
    """The counters of one step (arguments as :func:`count_plain`): the
    kernel for CUDA tensors, :func:`count_plain` for CPU ones."""
    dev = llr_t.device
    if dev.type == "cpu":
        return count_plain(frozen, llr_t, cw_t, hat_t)
    if dev.type != "cuda":
        raise ValueError(f"no count kernel for device {dev}")
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    batch = llr_t.shape[1] if llr_t.ndim == 2 else -1
    for name, t in (("llr_t", llr_t), ("cw_t", cw_t), ("hat_t", hat_t)):
        if (t.dtype != torch.int8 or tuple(t.shape) != (n, batch)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: expected contiguous ({n}, {batch}) "
                             f"int8 on {dev}, got {tuple(t.shape)} {t.dtype}")
    if batch == 0:
        return torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    blocks = -(-batch // FRAMES_PER_BLOCK)
    out = torch.empty((blocks, len(COUNTERS)), dtype=torch.int32, device=dev)
    err = build.load_library().polar_count(
        llr_t.data_ptr(), cw_t.data_ptr(), hat_t.data_ptr(),
        device_mask(frozen, dev).data_ptr(), n, batch, LANES, out.data_ptr(),
        stream)
    build.check(err, "polar_count")
    launches["count"] += 1
    return out.sum(dim=0, dtype=torch.int64)
