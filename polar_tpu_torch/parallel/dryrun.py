"""A dry run of the parallel layer on a mesh of ``n_devices`` positions.

The port's twin of ``__graft_entry__.py:dryrun_multichip``: six checks that
drive both kinds of parallelism end to end on tiny shapes,

1. the frame-sharded Monte-Carlo step (encode, channel, decode, summed
   counters);
2. the element-sharded systematic encoder against the local one;
3. the element-sharded decoder against the local decoder, bit for bit;
4. the same decode over the ring-shift kernel's transport (``"rdma"``);
5. Polar(1024, 512) through the frame-sharded step, its counters equal to
   the sum of the unsharded step run on each position's generator;
6. the frame-sharded decode throughput gauge.

``python -m polar_tpu_torch.parallel.dryrun [n_devices] [device]`` (by
default 8 positions on ``cuda``).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the six checks on a mesh of ``n_devices`` positions, all on
    ``device``; raises on the first that fails, else returns what they
    counted."""
    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda.step_kernel import COUNTERS

    from .campaign import (device_seeds, make_sharded_step,
                           measure_sharded_decode_fps)
    from .mesh import frame_mesh
    from .seqpar import element_mesh, make_sharded_encoder
    from .seqpar_decode import make_seqpar_decoder

    device = torch.device(device)
    devices = [device] * n_devices

    # 1. frame-sharded step with summed counters
    mesh = frame_mesh(devices)
    code = pt.make_code(6, rate=0.5)
    step, _ = make_sharded_step(code, mesh)
    out = {k: int(v) for k, v in step(device_seeds(0, mesh), 2.0, 16).items()}
    assert out["uncorrected_errors"] >= 0, out

    # 2. element-sharded systematic encoder against the local one
    emesh = element_mesh(devices)
    rng = np.random.default_rng(0)
    msg = torch.from_numpy(
        (1 - 2 * rng.integers(0, 2, (4, code.K))).astype(np.int8)).to(device)
    cw_sharded = make_sharded_encoder(code, emesh)(msg)
    assert torch.equal(cw_sharded, pt.encode_systematic(code, msg))

    # 3. element-sharded decoder against the local one (bit-exact); the
    # shard size must be >= 4
    dcode = pt.make_code(max(6, int(math.log2(n_devices)) + 2), rate=0.5)
    llr = torch.from_numpy(
        rng.integers(-128, 128, (8, dcode.N)).astype(np.int8)).to(device)
    u_local = pt.make_auto_decoder(dcode, device=device)[0](llr)
    u_sharded = make_seqpar_decoder(dcode, emesh, output="u")(llr)
    assert torch.equal(u_sharded, u_local)

    # 4. the ring-shift kernel's transport
    u_rdma = make_seqpar_decoder(dcode, emesh, output="u", comm="rdma")(llr)
    assert torch.equal(u_rdma, u_local)

    # 5. Polar(1024, 512) through the sharded step: the summed counters
    # EQUAL the unsharded step run on each position's generator
    rcode = pt.make_code(10, rate=0.5)
    per_dev = 128
    snr = -1.0   # below the waterfall: the counters must not be zero
    rstep, _ = make_sharded_step(rcode, mesh)
    sharded = {k: int(v) for k, v in
               rstep(device_seeds(7, mesh), snr, per_dev).items()}
    body = pt.make_step(rcode, device=device)
    local = dict.fromkeys(COUNTERS, 0)
    for g in device_seeds(7, mesh):
        for k, v in body(g, snr, per_dev).items():
            local[k] += int(v)
    assert sharded == local, (sharded, local)
    assert sharded["uncorrected_errors"] > 0, (
        "Polar(1024, 512) at -1 dB must show decode errors: the step is not "
        "exercising the chain")

    # 6. the frame-sharded throughput gauge. A chain of 8 usually resolves
    # the slope; on a loaded CPU the two readings of one can cross (a slope
    # of 0 or less), and the chain then grows fourfold until it resolves
    fps = measure_sharded_decode_fps(
        rcode, mesh, per_device_batch=128, iters=8, repeats=2, max_iters=128,
        max_rel_spread=float("inf"))
    assert fps > 0

    print(f"dryrun_multichip({n_devices}, {device}): OK - frame-sharded step "
          f"on {16 * n_devices} frames (counters {out}); element-sharded "
          f"encoder == local; element-sharded decoder (N={dcode.N} over "
          f"{n_devices} shards) == local over both transports; "
          f"Polar({rcode.N}, {rcode.K}) sharded step counters == the "
          f"unsharded step summed over {n_devices} generators ({sharded}); "
          f"throughput gauge {fps:.0f} frames/s per position", flush=True)
    return {"counters": out, "sharded": sharded, "fps": fps}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
