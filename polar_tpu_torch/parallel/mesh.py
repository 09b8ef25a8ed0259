"""Device meshes for sharded campaigns, driven from one process.

The port of ``polar_tpu.parallel.mesh``. The JAX package runs one SPMD
program over a ``Mesh`` of devices under ``shard_map``; the port drives
the same mesh from one process: a :class:`Mesh` is an axis name and a
tuple of torch devices, and a sharded value is a list of per-position
tensors, one per mesh position. A device may repeat, so eight positions on
``cuda:0`` are eight real buffers on one card, and the exchanges between
them move real bytes. Frames are embarrassingly parallel, so frame
parallelism shards the batch axis and reduces only the five counters;
processes on several hosts join through ``torch.distributed``
(:mod:`polar_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BATCH_AXIS = "frames"


def _indexed(device) -> torch.device:
    """``device`` as a torch device, a CUDA device with its index (that of
    torch's current device where none is given), as tensors report it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: ``axis`` and the device of each position
    (positions may share a device)."""

    axis: str
    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one position")
        object.__setattr__(self, "devices",
                           tuple(_indexed(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis: positions}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}


def frame_mesh(devices=None, axis: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over ``devices`` (torch devices or their names), or, with
    none given, over every CUDA device. Without a CUDA device it raises:
    it never falls back to the CPU, which a caller asks for by name."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the mesh's devices "
                               "(e.g. ['cpu'] * 8) to run without one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(axis, tuple(devices))


def split(x, mesh: Mesh, dim: int = 0) -> list:
    """Cut ``x`` into ``mesh.size`` equal blocks along ``dim``, block ``d``
    on position ``d``'s device (a view where it already lies there)."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows along dim {dim} do not split over "
                         f"{mesh.size} positions")
    return [b.to(dev) for b, dev in zip(torch.chunk(x, mesh.size, dim=dim),
                                        mesh.devices)]


def gather(blocks, dim: int = 0, device=None):
    """The blocks of a sharded value joined along ``dim`` on ``device``
    (by default the first block's)."""
    device = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def shard_batch(x, mesh: Mesh) -> list:
    """A global frame-major ``(B, ...)`` tensor as per-position frame
    blocks (the counterpart of ``batch_sharding``)."""
    return split(x, mesh, 0)


def gather_batch(blocks, device=None):
    """Per-position frame blocks joined back into the global batch."""
    return gather(blocks, 0, device)


def replicate(x, mesh: Mesh) -> list:
    """``x`` on every position (the counterpart of ``replicated``): the
    tensor itself where it lies on the position's device, else a copy."""
    return [x.to(dev) for dev in mesh.devices]
