"""The ring shift across a mesh's shards on the card: wrapper and plain
version.

The kernel (``csrc/ring.cu``) replaces ``polar_tpu/parallel/rdma.py:
ring_shift`` (``:61``, body ``_shift_kernel`` ``:42-58``): over the
per-position blocks of a sharded value, ``y[d] = x[(d + offset) % n]``,
for pulls (``offset > 0``) and pushes (``offset < 0``), on any payload of
one shape and dtype across the shards.

:func:`ring_shift` launches the kernel when the blocks lie on CUDA devices
and runs :func:`ring_shift_plain` only when they lie on the CPU. It makes
one launch per destination device, on that device's current stream, with
every output allocated there: one launch for a mesh whose positions share
a card. A source on another card is read through peer access: the
destination's stream first waits on an event of the source's, and the
source's stream then waits on the launch, so the source's memory is not
reused before it has been read. Stream order stands in for the TPU
kernel's barrier semaphores and the decoder's serialising token: a
program driven from one process, one stream per device, is already
totally ordered. That multi-card path is written but was measured on no
machine with more than one card.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from . import build

THREADS = 256
MAX_SHARDS = 64   # csrc/ring.cu kMaxShards: the pointers one launch carries
launches = {"ring_shift": 0}
plain_calls = {"ring_shift_plain": 0}


def _check_blocks(blocks):
    if not blocks:
        raise ValueError("ring_shift needs at least one block")
    shape, dtype = blocks[0].shape, blocks[0].dtype
    for b in blocks:
        if b.shape != shape or b.dtype != dtype:
            raise ValueError(
                "ring_shift: every block must have one shape and dtype, got "
                f"{[(tuple(x.shape), x.dtype) for x in blocks]}")


def ring_shift_plain(blocks, offset: int) -> list:
    """``y[d] = blocks[(d + offset) % n]``, each a fresh copy on
    ``blocks[d]``'s device. The plain version of :func:`ring_shift`, and
    the element-sharded decoder's ``comm="ppermute"`` transport."""
    _check_blocks(blocks)
    plain_calls["ring_shift_plain"] += 1
    n = len(blocks)
    return [blocks[(d + offset) % n].to(blocks[d].device, copy=True)
            for d in range(n)]


def _launch(pairs, nbytes: int, stream: int) -> None:
    """One launch a chunk of :data:`MAX_SHARDS` pairs, under one span."""
    start = profiling.begin()
    for i in range(0, len(pairs), MAX_SHARDS):
        chunk = pairs[i:i + MAX_SHARDS]
        srcs = (ctypes.c_void_p * len(chunk))(*(s.data_ptr() for s, _ in chunk))
        dsts = (ctypes.c_void_p * len(chunk))(*(d.data_ptr() for _, d in chunk))
        err = build.load_library().polar_ring_shift(
            ctypes.addressof(srcs), ctypes.addressof(dsts), len(chunk), nbytes,
            THREADS, stream)
        build.check(err, "polar_ring_shift")
    profiling.launched(start, launches, "ring_shift",
                       -(-len(pairs) // MAX_SHARDS))


def ring_shift(blocks, offset: int) -> list:
    """``y[d] = blocks[(d + offset) % n]`` (see the module docstring): the
    kernel for blocks on CUDA devices, :func:`ring_shift_plain` for blocks
    on the CPU. Every output is a new tensor on ``blocks[d]``'s device."""
    _check_blocks(blocks)
    devs = [b.device for b in blocks]
    if all(d.type == "cpu" for d in devs):
        return ring_shift_plain(blocks, offset)
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"no ring-shift kernel for devices {devs}")
    n = len(blocks)
    src = [b.contiguous() for b in blocks]
    nbytes = src[0].numel() * src[0].element_size()
    out = [None] * n
    groups: dict = {}
    for d in range(n):
        groups.setdefault(devs[d], []).append(d)
    for dev, positions in groups.items():
        stream = build.stream(dev)
        pairs = []
        for d in positions:
            out[d] = torch.empty_like(src[d], device=dev)
            pairs.append((src[(d + offset) % n], out[d]))
        if nbytes == 0:
            continue
        peers = {s.device for s, _ in pairs} - {dev}
        for peer in peers:
            build.check(build.load_library().polar_enable_peer(
                dev.index, peer.index), f"peer access {dev} -> {peer}")
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(peer))
            torch.cuda.current_stream(dev).wait_event(ready)
        build.stream(dev)   # polar_enable_peer moved the current device
        _launch(pairs, nbytes, stream)
        for peer in peers:
            read = torch.cuda.Event()
            read.record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(peer).wait_event(read)
    return out
