"""The control of ``correct``, and the readings its limits are set from.

The control is the plain reference put in the program's place and computed
in the precision below the configuration's: 4-bit saturating LLRs and
decoder arithmetic where the configuration states int8. A cell's check
has to come out as not correct with it. This script runs a cell's window
and check with the control in place, on each of ``--seeds``, and with
``--program`` the program itself too, in one process, and prints each
run's numbers compared, one JSON line a run:

    python3 perfbench/control.py --workload n16384.campaign \\
        --seeds 11 12 13 --seconds 2 [--program]

The benchmark's own runs never run it. ``perfbench/tests`` keeps the same
control, and the planted faults, at a size a CPU test run holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CONTROL_BITS = 4


def control_wrap(kind: str, config: dict, mix: dict, device):
    """A ``wrap`` for :func:`harness.run` that puts the reference at
    :data:`CONTROL_BITS` bits in the program's place for traffic ``kind``."""
    import torch

    from reference import construction, polar

    code = polar.Code(construction.frozen_mask(
        config["level"], config["K"], config["design_snr_offset_db"]),
        device, bits=CONTROL_BITS)
    chunk = max(1, min(int(mix["batch"]), (1 << 25) // code.n))

    def step(gen, snr_db, batch, steps=1):
        total = [0] * 5
        for _ in range(steps):
            key = tuple(int(s) for s in torch.randint(
                0, 2**32, (2,), generator=gen, dtype=torch.int64))
            for i, c in enumerate(code.step_counters(key, snr_db, batch,
                                                     chunk)):
                total[i] += c
        return {name: torch.tensor(v) for name, v in zip(polar.COUNTERS,
                                                          total)}

    def decode(llr):
        return code.decode_frames(llr, chunk)

    return lambda program: step if kind == "campaign_point" else decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true",
                    help="also run the program itself on each seed")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(REPO)]
    import torch

    import harness

    bench = harness.Bench.from_file(REPO / "BENCHMARK.json")
    cell = bench.workload(args.workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    device = torch.device("cuda")
    arms = [("control", control_wrap(mix["kind"], config, mix, device))]
    if args.program:
        arms.insert(0, ("program", None))
    for seed in args.seeds:
        for arm, wrap in arms:
            out = harness.run(bench, args.workload, seed, args.seconds, False,
                              t_start=time.perf_counter(), wrap=wrap)
            print(json.dumps({"workload": args.workload, "arm": arm,
                              "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "failed": out["failed"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
