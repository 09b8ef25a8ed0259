"""Where the interpreter's tile kernel spends its time, on one CUDA device.

For the cw track of Polar(2^m, 2^(m-1))'s program (decode+count's, the
kernel alone, no counter) at subtree level ``--subtree-level``, on
full-range int8 LLRs, it times by CUDA events, at each grid level of
``--grid-levels``, the kernel on its schedule and on variants of it that
keep every grid barrier but empty some entries (an empty entry moves no
data): the tile runs alone, the grid entries alone, the grid entries of
the leaf bodies and grate1s above G alone, and the barriers alone; then
one tile run by itself (the program's first), and the device time of
the whole schedule by torch.profiler. The variants compute nothing a
caller could use: only their times are read. It also prints the bytes the
grid entries move (:func:`grid_bytes`, a count on the host). Every line
names the card and its power limit.

    python -m polar_tpu_torch.utils.interp_probe [--m 17] [--batch 4096]
        [--subtree-level 10] [--grid-levels 11,12]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys

EMPTY = 0xFF   # a schedule entry kind the kernel does nothing for


def _variant(c, keep):
    """``c`` with every schedule entry ``i`` for which ``keep(i)`` is false
    emptied (its barrier kept)."""
    from polar_tpu_torch.ops.cuda import interp_kernel as ik

    e = c.sched.entries.copy()
    for i in range(len(e)):
        if not keep(i):
            e[i, 0] = (e[i, 0] & ik.CHAIN) | EMPTY
            e[i, 1] = 0
    return dataclasses.replace(c, sched=dataclasses.replace(c.sched, entries=e),
                               _dev={})


def grid_bytes(sched, batch: int) -> int:
    """The bytes the grid entries of ``sched`` move through device memory
    at ``batch`` frames, each operand row of each entry read or written
    once (a 1-row operand, an SPC's key or a REP's sum, counted as one
    row)."""
    from polar_tpu_torch.ops.cuda import interp_kernel as ik

    per_kind = {ik.S_F: 3, ik.S_ADD: 3, ik.S_HMUL: 3, ik.S_KEY: 3,
                ik.S_KEYRED: 3, ik.S_G: 4, ik.S_COPY: 2, ik.S_STAGE: 4,
                ik.S_FILL: 1}
    rows = 0
    for kind, cnt, _, _, rc, rd, re, _ in sched.entries.tolist():
        kind &= 0xFF
        if kind in per_kind:
            rows += per_kind[kind] * cnt
        elif kind == ik.S_GRATE1:     # reads h, a, b; writes d (and h, e)
            rows += (4 + 2 * (re >= 0)) * cnt
        elif kind == ik.S_RATE1:      # reads a; writes d (and c)
            rows += (2 + (rc >= 0)) * cnt
        elif kind == ik.S_FLIP:       # reads a and the key; writes d (and c)
            rows += (2 + (rc >= 0)) * cnt + 1
        elif kind == ik.S_REPBC:      # reads the sum; writes c, d (and e)
            rows += ((rc >= 0) + (rd >= 0)) * cnt + 1 + (re >= 0)
    return rows * batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=17)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--subtree-level", type=int, default=10)
    ap.add_argument("--grid-levels", default="11,12")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import interp_kernel as ik
    from polar_tpu_torch.utils.benchmark import elapsed_seconds

    if not torch.cuda.is_available():
        print("interp_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    code = pt.make_code(args.m, rate=0.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.m)
    llr = torch.randint(-128, 128, (code.N, args.batch), generator=gen,
                        device=dev, dtype=torch.int8)

    def ms(c):
        def run():
            for _ in range(args.reps):
                ik._run_tile(c, llr, hard_out=False,
                             what="interp_decode_count")
        run()
        torch.cuda.synchronize()
        return elapsed_seconds(run, "cuda") / args.reps * 1e3

    for g in (int(x) for x in args.grid_levels.split(",")):
        c = ik._compile(pt.compile_code(code), code.frozen, args.subtree_level,
                        True, False, grid_level=g)
        s = c.sched
        kinds = s.entries[:, 0] & 0xFF
        desc_kind = c.desc[c.words & 0xFFFF, 0]
        wide = {i for i, o in enumerate(s.origin)
                if kinds[i] != ik.RUN and o >= 0
                and desc_kind[o] in (ik.BODY, ik.GRATE1)}
        first = next(i for i in range(len(kinds)) if kinds[i] == ik.RUN)
        variants = {
            "schedule": c,
            "tile runs": _variant(c, lambda i: kinds[i] == ik.RUN),
            "grid entries": _variant(c, lambda i: kinds[i] != ik.RUN),
            "leaf and grate1 grid entries": _variant(c, lambda i: i in wide),
            "barriers": _variant(c, lambda i: False),
            "first tile run": _variant(c, lambda i: i == first),
        }
        plan = ik._launch_plan(c, args.batch, dev)
        print(f"Polar({code.N}, {code.K}) cw track sl{args.subtree_level} "
              f"B={args.batch} G={s.grid_level}: {plan} ({card})", flush=True)
        print(f"  grid entries move {grid_bytes(s, args.batch)} bytes "
              f"(each operand row once)", flush=True)
        for name, v in variants.items():
            print(f"  {name}: {ms(v):.4f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                ik._run_tile(c, llr, hard_out=False, what="interp_decode_count")
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        print(f"  schedule, device time (profiler): "
              f"{us / 1e3 / args.reps:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
