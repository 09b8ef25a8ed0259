"""Intra-frame (sequence-parallel) sharded polar transform and encoder.

The port of ``polar_tpu.parallel.seqpar``. For very large N the codeword's
element axis shards over the mesh. Butterfly stage h pairs element j with
j + h (``polar_encoder.hh:23-26``):

* stages with ``h`` below the shard size never cross a shard boundary and
  run locally, as the ordinary butterfly
  (:func:`polar_tpu_torch.ops.transform.polar_transform`);
* stages with ``h`` at or above it pair each shard with the one ``h / S``
  positions away: one exchange per stage pulls the partner block and the
  lower half of each 2h block multiplies by it (the role mask of
  ``polar_tpu/parallel/seqpar.py:46-62``, a per-position choice here).

log2(n) neighbour exchanges, no gather. A sharded value is the list of
per-position blocks (:mod:`.mesh`); the exchanges go through the plain
transport, as the JAX encoder's go through ``ppermute``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..code.construction import PolarCode
from ..ops.cuda.ring_kernel import ring_shift_plain
from ..ops.transform import polar_transform
from .mesh import Mesh, frame_mesh, gather, replicate

SEQ_AXIS = "seq"


def element_mesh(devices=None, axis: str = SEQ_AXIS) -> Mesh:
    """1-D mesh for the element axis (see :func:`.mesh.frame_mesh`)."""
    return frame_mesh(devices, axis)


def sharded_transform(blocks) -> list:
    """The polar transform of a ``(..., N)`` value sharded along its last
    axis: ``blocks[d]`` holds elements ``[d S, (d + 1) S)``."""
    n = len(blocks)
    x = [polar_transform(b) for b in blocks]
    h = 1
    while h < n:
        # receive the block h positions ahead (d + h wraps harmlessly: the
        # wrapped receivers are upper-role and keep their own block)
        partner = ring_shift_plain(x, h)
        x = [x[d] * partner[d] if (d // h) % 2 == 0 else x[d]
             for d in range(n)]
        h *= 2
    return x


def make_sharded_transform(mesh: Mesh, axis: str = SEQ_AXIS):
    """``transform(blocks)`` over ``mesh[axis]``: per-position blocks
    ``(..., S)`` of a ``(..., N)`` value in, the transformed blocks out,
    on the same devices."""
    n_shards = mesh.shape[axis]

    def transform(blocks):
        if len(blocks) != n_shards:
            raise ValueError(f"expected {n_shards} blocks, got {len(blocks)}")
        return sharded_transform(blocks)

    return transform


def make_sharded_encoder(code: PolarCode, mesh: Mesh, axis: str = SEQ_AXIS,
                         systematic: bool = True):
    """Element-sharded encoder for huge N: ``encode(message)`` takes the
    ``(..., K)`` message and returns the global ``(..., N)`` codeword on
    the message's device; ``encode.shards(message)`` returns its
    per-position ``(..., S)`` blocks. The scatter and the re-freeze are
    elementwise on each block; the transforms are
    :func:`make_sharded_transform`'s. Mirrors ``polar_encoder.hh:30-59``."""
    n_shards = mesh.shape[axis]
    if code.N % n_shards:
        raise ValueError(f"N={code.N} not divisible by {n_shards} shards")
    shard = code.N // n_shards
    transform = make_sharded_transform(mesh, axis)
    frozen = np.asarray(code.frozen, dtype=bool)
    # scatter map: u[j] = message[scatter_idx[j]] for info slots
    scatter_idx = np.zeros(code.N, dtype=np.int64)
    scatter_idx[~frozen] = np.arange(code.K)
    tables: dict = {}

    def table(d, dev):
        key = (d, str(dev))
        if key not in tables:
            sl = slice(d * shard, (d + 1) * shard)
            tables[key] = (torch.as_tensor(frozen[sl], device=dev),
                           torch.as_tensor(scatter_idx[sl], device=dev))
        return tables[key]

    def shards(message):
        blocks = []
        for d, msg in enumerate(replicate(message, mesh)):
            frz, idx = table(d, msg.device)
            blocks.append(torch.where(frz, torch.ones((), dtype=msg.dtype,
                                                      device=msg.device),
                                      msg[..., idx]))
        x = transform(blocks)
        if systematic:
            x = transform([torch.where(table(d, b.device)[0],
                                       torch.ones_like(b), b)
                           for d, b in enumerate(x)])
        return x

    def encode(message):
        return gather(shards(message), -1, message.device)

    encode.shards = shards
    return encode
