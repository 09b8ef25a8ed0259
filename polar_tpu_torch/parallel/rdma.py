"""The exchange transports of the element-sharded decoder.

The port of ``polar_tpu.parallel.rdma``. The element-sharded f / g / comb
exchanges (:mod:`.seqpar_decode`) move a partner block between positions
at every cross-shard tree level, as one whole ring shift
``y[d] = x[(d + offset) % n]`` over the mesh. Two transports:

* ``"ppermute"`` — :func:`~polar_tpu_torch.ops.cuda.ring_kernel.ring_shift_plain`,
  one ``Tensor.to(copy=True)`` per position (the JAX package's
  ``jax.lax.ppermute``);
* ``"rdma"`` — :func:`~polar_tpu_torch.ops.cuda.ring_kernel.ring_shift`,
  the hand-written CUDA ring-shift kernel (``csrc/ring.cu``), one launch
  per destination device; on CPU blocks its plain version.

The TPU kernel's neighbour barrier and the token that keeps two RDMA
exchanges from running at once have no counterpart: one process drives the
mesh, each device's launches run in the order of its stream, and a
cross-device read waits on an event of the source's stream. Both
transports give identical values.
"""

from __future__ import annotations

from ..ops.cuda.ring_kernel import ring_shift, ring_shift_plain

TRANSPORTS = {"ppermute": ring_shift_plain, "rdma": ring_shift}


def transport(comm: str):
    """The ring shift ``fn(blocks, offset)`` of a transport name."""
    if comm not in TRANSPORTS:
        raise ValueError(f"unknown comm transport {comm!r}")
    return TRANSPORTS[comm]


__all__ = ["TRANSPORTS", "ring_shift", "ring_shift_plain", "transport"]
