"""Frame-sharded Monte-Carlo campaign: frames over the mesh, summed counters.

The port of ``polar_tpu.parallel.campaign``. Each mesh position runs the
port's Monte-Carlo step (:func:`polar_tpu_torch.ber.make_step`) on its own
device with its own generator, and the five counters are summed onto the
first position's device (the ``psum``): the only traffic between
positions, a few dozen bytes a step. The decode never communicates, since
frames are independent, as the reference's SIMD lanes are.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..code.construction import PolarCode
from ..ops.cuda.step_kernel import COUNTERS
from .mesh import BATCH_AXIS, Mesh, frame_mesh, shard_batch


def _process() -> tuple[int, int]:
    """(rank, world size) of this process in ``torch.distributed``, or
    (0, 1) when it runs alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_sharded_step(
    code: PolarCode,
    mesh: Mesh | None = None,
    *,
    axis: str = BATCH_AXIS,
    systematic: bool = True,
    dtype=torch.int8,
    decoder=None,
    fused: str | bool = "auto",
):
    """Build the sharded Monte-Carlo step.

    Returns ``(step, mesh)`` where ``step(gens, snr_db, per_device_batch)``
    takes one host generator per mesh position (:func:`device_seeds`),
    runs :func:`polar_tpu_torch.ber.make_step`'s step of
    ``per_device_batch`` frames on each position's device with its
    generator, and returns the counters summed over the positions, 0-d
    int64 tensors on the first position's device. The global batch is
    ``mesh.size * per_device_batch``. ``decoder`` and ``fused`` go to
    ``make_step``."""
    from ..ber import make_step

    if mesh is None:
        mesh = frame_mesh(axis=axis)
    steps: dict = {}
    for dev in mesh.devices:
        if dev not in steps:
            steps[dev] = make_step(code, systematic=systematic, dtype=dtype,
                                   decoder=decoder, fused=fused, device=dev)
    first = mesh.devices[0]

    def step(gens, snr_db, per_device_batch: int):
        if len(gens) != mesh.size:
            raise ValueError(f"expected {mesh.size} generators, got "
                             f"{len(gens)}")
        outs = [steps[dev](g, snr_db, per_device_batch)
                for g, dev in zip(gens, mesh.devices)]
        return {name: sum(torch.as_tensor(o[name]).to(first) for o in outs)
                for name in COUNTERS}

    return step, mesh


def device_seeds(seed: int, mesh: Mesh, *, first: int = 0) -> list:
    """One host generator per mesh position, seeded from ``seed`` and the
    position's global index (``first`` + its index in the mesh: a
    process of a multi-process campaign passes the index of its first
    position). The counterpart of ``device_keys``."""
    children = np.random.SeedSequence(seed).spawn(first + mesh.size)[first:]
    gens = []
    for child in children:
        g = torch.Generator()
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def global_llr_batch(code, mesh: Mesh | None = None, *,
                     axis: str = BATCH_AXIS, per_device_batch: int = 4096,
                     seed: int = 42) -> list:
    """Random full-range int8 LLRs, ``per_device_batch`` frames ``(B, N)``
    on each mesh position, from process-local data: each process draws
    only its own positions' rows (its own stream, ``seed`` + its rank), so
    no process holds the global batch."""
    if mesh is None:
        mesh = frame_mesh(axis=axis)
    rank, _ = _process()
    rng = np.random.default_rng(seed + rank)
    local = rng.integers(-128, 128, (mesh.size * per_device_batch, code.N))
    return shard_batch(torch.from_numpy(local.astype(np.int8)), mesh)


def measure_sharded_decode_fps(code, mesh: Mesh | None = None, *,
                               axis: str = BATCH_AXIS,
                               per_device_batch: int = 4096, decoder=None,
                               seed: int = 42, iters: int = 16,
                               warmup: bool = True, repeats: int = 3,
                               max_iters: int = 4096,
                               max_rel_spread: float = 0.25) -> float:
    """Frame-sharded decode throughput over the mesh, in frames/s per
    position, by the chained slope method
    (:func:`polar_tpu_torch.utils.benchmark.slope_seconds_per_iter`): a
    timed run chains ``it`` decodes on every position (each input
    perturbed by the previous output), then waits for every device. The
    decoder is the auto decoder of the first position's device unless
    given. In a multi-process campaign every process returns the lead
    process's figure."""
    from ..decode.auto import make_auto_decoder
    from ..utils.benchmark import _chained_runner, slope_seconds_per_iter

    if mesh is None:
        mesh = frame_mesh(axis=axis)
    if decoder is None:
        decoder, _ = make_auto_decoder(code, output_dtype=torch.int8,
                                       device=mesh.devices[0])
    blocks = global_llr_batch(code, mesh, per_device_batch=per_device_batch,
                              seed=seed)
    runner = _chained_runner(decoder,
                             code.N - decoder(blocks[0][:1]).shape[-1])
    cards = sorted({d for d in mesh.devices if d.type == "cuda"},
                   key=str)

    def wait():
        for d in cards:
            torch.cuda.synchronize(d)

    def timed(it):
        wait()
        t0 = time.perf_counter()
        for x in blocks:
            runner(x, it)
        wait()
        return time.perf_counter() - t0

    slope = slope_seconds_per_iter(timed, iters, warmup=warmup,
                                   repeats=repeats, max_iters=max_iters,
                                   max_rel_spread=max_rel_spread)
    fps = per_device_batch / slope
    rank, world = _process()
    if world > 1:
        import torch.distributed as dist

        box = [fps]
        dist.broadcast_object_list(box, src=0)
        fps = box[0]
    return fps


def run_sharded_point(
    code: PolarCode,
    snr_db: float,
    *,
    seed: int,
    step=None,
    mesh: Mesh | None = None,
    per_device_batch: int = 4096,
    max_global_frames: int = 1 << 20,
    target_bit_errors: int = 1000,
    systematic: bool = True,
    dtype=torch.int8,
):
    """The sharded counterpart of :func:`polar_tpu_torch.ber.run_point`:
    sharded steps until the error target or the frame budget is met, the
    positions' generators made once from ``seed`` (:func:`device_seeds`);
    returns the counter totals and the global frame count (``"frames"``).
    A pure function of ``seed``."""
    if step is None:
        step, mesh = make_sharded_step(code, mesh, systematic=systematic,
                                       dtype=dtype)
    if mesh is None:
        raise ValueError("a step passed in needs its mesh")
    gens = device_seeds(seed, mesh)
    totals = dict.fromkeys(COUNTERS, 0)
    frames = 0
    while (frames < max_global_frames
           and totals["uncorrected_errors"] < target_bit_errors):
        out = step(gens, snr_db, per_device_batch)
        frames += per_device_batch * mesh.size
        pulled = torch.stack([out[name] for name in COUNTERS]).tolist()
        for name, v in zip(COUNTERS, pulled):
            totals[name] += v
    totals["frames"] = frames
    return totals
