"""Multi-process campaign entry: torch.distributed and the sharded step.

The port of ``polar_tpu.parallel.multihost``. Every process calls
:func:`initialize_multihost`, builds its local mesh and runs the sharded
Monte-Carlo step (:mod:`.campaign`) on it; after each step the counters,
pulled to the host, are summed over the processes with one gloo
``all_reduce`` of five int64s. Every process therefore sees the same
totals and takes the same branches of the sweep, and processes may share a
card. Without a coordinator, :func:`initialize_multihost` is a no-op and a
single process runs alone.

Launch one command per process:

    python -m polar_tpu_torch.parallel.multihost --m 15 --rate 0.5 \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0

(or with PyTorch's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
``WORLD_SIZE`` set instead of the three flags). ``--device cpu`` runs the
campaign on the CPU; ``--positions`` sets the local mesh's size.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch
import torch.distributed as dist


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> bool:
    """Join the process group over gloo if a coordinator is configured.

    ``coordinator`` (``host:port``) with ``num_processes`` and
    ``process_id``; else PyTorch's ``env://`` variables when
    ``MASTER_ADDR``, ``RANK`` and ``WORLD_SIZE`` are all set. Returns True
    when running multi-process; without either it leaves this process
    alone and returns False. Safe to call twice."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return True
    if all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        dist.init_process_group("gloo", init_method="env://")
        return True
    return False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_lead_host() -> bool:
    return process_index() == 0


def _all_sum(values: list) -> list:
    """The element-wise sum of ``values`` (ints) over the processes."""
    if process_count() == 1:
        return values
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t)
    return t.tolist()


def run_multihost_campaign(code, *, seed=0, systematic=True, dtype=None,
                           per_device_batch=2048, max_global_frames=1 << 20,
                           target_bit_errors=1000, snr_range=None,
                           snr_step=0.1, stop_after_clean=4, verbose=True,
                           checkpoint_path=None, mesh=None):
    """SNR sweep over every process's mesh (by default
    :func:`.mesh.frame_mesh`'s, every CUDA device).

    Each SNR point draws one seed from a host generator seeded with
    ``seed``, the same on every process; each process's positions take
    their generators from it at their global indices
    (:func:`.campaign.device_seeds`), so no two positions share a stream.
    The sweep consumes only the all-reduced totals, so every process takes
    the same branches; only the lead process prints and writes.

    With ``checkpoint_path`` the lead process rewrites the result JSON after
    every point; on restart it reloads the completed points and broadcasts
    them to every process, so all skip the same points and their
    collective calls stay aligned even where only the lead has the file."""
    from ..ber import ebn0_db
    from ..code.construction import design_snr_db
    from ..ops.cuda.step_kernel import COUNTERS
    from .campaign import device_seeds, make_sharded_step
    from .mesh import frame_mesh

    if dtype is None:
        dtype = torch.int8
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    if mesh is None:
        mesh = frame_mesh()
    step, _ = make_sharded_step(code, mesh, systematic=systematic, dtype=dtype)
    n_local = mesh.size
    n_global = sum(_all_sum([n_local]))
    first = sum(_gather_counts(n_local)[:process_index()])
    gen = torch.Generator()
    gen.manual_seed(seed)

    done = _load_checkpoint_all_hosts(checkpoint_path, code, seed)

    points = []
    clean = 0
    snr = snr_range[0]
    while snr <= snr_range[1] + 1e-9 and clean < stop_after_clean:
        point_seed = int(torch.randint(0, 2**63 - 1, (), generator=gen))
        snr_r = round(snr, 6)
        if snr_r in done:
            frames, totals = done[snr_r]
        else:
            gens = device_seeds(point_seed, mesh, first=first)
            totals = dict.fromkeys(COUNTERS, 0)
            frames = 0
            while (frames < max_global_frames
                   and totals["uncorrected_errors"] < target_bit_errors):
                out = step(gens, snr_r, per_device_batch)
                local = torch.stack([out[name] for name in COUNTERS]).tolist()
                for name, v in zip(COUNTERS, _all_sum(local)):
                    totals[name] += v
                frames += per_device_batch * n_global
        ber = totals["uncorrected_errors"] / (frames * code.K)
        points.append({
            "snr_db": snr_r,
            "ebn0_db": ebn0_db(snr, code.rate),
            "frames": frames,
            "bit_errors": totals["uncorrected_errors"],
            "frame_errors": totals["frame_errors"],
            "ber": ber,
            "fer": totals["frame_errors"] / frames,
        })
        clean = clean + 1 if totals["uncorrected_errors"] == 0 else 0
        if verbose and is_lead_host():
            print(f"{snr:.1f} {ber:g} - {ebn0_db(snr, code.rate):g}",
                  flush=True)
        if checkpoint_path is not None and is_lead_host():
            _save_checkpoint(checkpoint_path, code, seed, points)
        snr += snr_step
    return points


def _gather_counts(n_local: int) -> list:
    """Every process's position count, in rank order."""
    if process_count() == 1:
        return [n_local]
    counts = [None] * process_count()
    dist.all_gather_object(counts, n_local)
    return counts


def _save_checkpoint(path, code, seed, points) -> None:
    """Atomic JSON checkpoint (lead process only)."""
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"code_n": code.N, "code_k": code.K, "seed": seed,
                   "points": points}, f, indent=1)
    os.replace(tmp, str(path))


def _load_checkpoint_all_hosts(path, code, seed):
    """{snr: (frames, counter totals)} of completed points, the same on
    every process: only the lead process reads the file, and its rows reach
    the others by ``broadcast_object_list``, so processes without the file
    skip the same points."""
    if path is None:
        return {}
    rows = []
    if is_lead_host() and os.path.exists(str(path)):
        try:
            with open(str(path)) as f:
                prev = json.load(f)
            if (prev.get("code_n"), prev.get("code_k")) == (code.N, code.K) \
                    and prev.get("seed") in (None, seed):
                rows = [[p["snr_db"], p["frames"], p["bit_errors"],
                         p["frame_errors"]] for p in prev.get("points", [])]
        except (OSError, ValueError, KeyError):
            rows = []
    if process_count() > 1:
        box = [rows]
        dist.broadcast_object_list(box, src=0)
        rows = box[0]
    return {
        round(float(r[0]), 6): (
            int(r[1]),
            {"uncorrected_errors": int(r[2]), "frame_errors": int(r[3])},
        )
        for r in rows
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=15)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-device-batch", type=int, default=2048)
    ap.add_argument("--max-global-frames", type=int, default=1 << 20)
    ap.add_argument("--target-errors", type=int, default=1000)
    ap.add_argument("--snr-min", type=float, default=None)
    ap.add_argument("--snr-max", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=0.1)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JSON checkpoint path (the lead process writes it "
                         "after every SNR point; completed points are "
                         "skipped on restart)")
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (every CUDA device), 'cuda:i' or 'cpu'")
    ap.add_argument("--positions", type=int, default=None,
                    help="mesh positions of this process, laid over its "
                         "devices in turn (default: one per device)")
    args = ap.parse_args(argv)

    from ..code.construction import make_code
    from .mesh import frame_mesh

    multi = initialize_multihost(args.coordinator, args.num_processes,
                                 args.process_id)
    devices = None if args.device == "cuda" else [torch.device(args.device)]
    mesh = frame_mesh(devices)
    if args.positions is not None:
        mesh = frame_mesh([mesh.devices[i % mesh.size]
                           for i in range(args.positions)])
    if is_lead_host():
        print(f"positions: {mesh.size} on {sorted(set(map(str, mesh.devices)))}"
              f" ({process_count()} processes, multihost={multi})",
              file=sys.stderr)
    code = make_code(args.m, rate=args.rate)
    snr_range = None
    if args.snr_min is not None and args.snr_max is not None:
        snr_range = (args.snr_min, args.snr_max)
    points = run_multihost_campaign(
        code, seed=args.seed, per_device_batch=args.per_device_batch,
        max_global_frames=args.max_global_frames,
        target_bit_errors=args.target_errors,
        snr_range=snr_range, snr_step=args.snr_step,
        checkpoint_path=args.checkpoint, mesh=mesh,
    )
    # every process prints its points, which must agree across processes
    print(json.dumps({"process": process_index(), "points": points}),
          flush=True)
    if args.out and is_lead_host():
        with open(args.out, "w") as f:
            json.dump({"code_n": code.N, "code_k": code.K, "points": points},
                      f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
