"""BER waterfall campaign CLI of polar_tpu_torch, the testbench.cc
equivalent (the port of ``scripts/waterfall.py``).

Runs the full Monte-Carlo sweep for one code, prints the reference's
4-column table (SNR BER Mbit/s Eb/N0, ``testbench.cc:218``) plus the
"QEF at" summary line (``testbench.cc:221``), and writes a resumable
JSON checkpoint and optional PNG waterfall plot. Runs on ``--device``
(default ``cuda``).

Examples:
  python -m polar_tpu_torch.waterfall --m 17 --rate 0.5 --batch 4096 --out n131072.json
  python -m polar_tpu_torch.waterfall --m 10 --non-systematic --plot wf.png
  python -m polar_tpu_torch.waterfall --m 6 --device cpu
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--m", type=int, default=14, help="log2(N), default 14")
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=None, help="override K")
    ap.add_argument("--non-systematic", action="store_true")
    ap.add_argument("--threshold", type=float, default=None, metavar="T",
                    help="threshold-mode construction (the testbench's "
                         "alternate branch, testbench.cc:78-81): freeze "
                         "every bit whose erasure probability exceeds T; "
                         "K becomes an OUTPUT (--rate/--k are ignored)")
    ap.add_argument("--erasure-probability", type=float, default=0.5,
                    metavar="PE", help="channel erasure probability fed to "
                         "the threshold-mode recursion (default 0.5, the "
                         "testbench's)")
    ap.add_argument("--dtype", choices=["int8", "float32"], default="int8")
    ap.add_argument("--compute", default=None,
                    help="compute mode: int8|qfloat|qfloat-f32|float32")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--max-frames", type=int, default=1 << 14,
                    help="max frames per SNR point")
    ap.add_argument("--target-errors", type=int, default=1000)
    ap.add_argument("--snr-step", type=float, default=0.1)
    ap.add_argument("--snr-min", type=float, default=None)
    ap.add_argument("--snr-max", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="JSON checkpoint/result path (resumable)")
    ap.add_argument("--plot", type=str, default=None, help="PNG output path")
    ap.add_argument("--no-throughput", action="store_true")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="chain this many Monte-Carlo steps per host pull "
                         "of the counters")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)

    import torch

    import polar_tpu_torch as pt

    if args.threshold is not None:
        code = pt.make_code_threshold(args.m, args.erasure_probability,
                                      args.threshold)
        design = pt.design_snr_db(args.erasure_probability)
    else:
        code = pt.make_code(args.m, K=args.k,
                            rate=None if args.k else args.rate)
        design = pt.design_snr_db(1.0 - code.rate)
    print(f"design SNR: {design:.5g}", file=sys.stderr)
    print(f"Polar({code.N}, {code.K})", file=sys.stderr)
    prog = pt.compile_program(code)
    print(f"program length = {len(prog)}", file=sys.stderr)
    print("SNR BER Mbit/s Eb/N0", file=sys.stderr)

    snr_range = None
    if args.snr_min is not None or args.snr_max is not None:
        lo = args.snr_min if args.snr_min is not None else math.floor(design - 3)
        hi = args.snr_max if args.snr_max is not None else math.ceil(design + 5)
        snr_range = (lo, hi)

    result = pt.run_campaign(
        code,
        seed=args.seed,
        systematic=not args.non_systematic,
        dtype=getattr(torch, args.dtype),
        compute=args.compute,
        batch=args.batch,
        max_frames_per_point=args.max_frames,
        target_bit_errors=args.target_errors,
        snr_range=snr_range,
        snr_step=args.snr_step,
        measure_throughput=not args.no_throughput,
        verbose=True,
        checkpoint_path=args.out,
        steps_per_call=args.steps_per_call,
        device="cpu" if args.cpu else args.device,
    )
    qef = result.qef_snr_db
    print(f"QEF at: {qef if math.isfinite(qef) else 'n/a'} SNR, "
          f"speed: {result.peak_mbps:.1f} Mb/s.", file=sys.stderr)
    if args.plot:
        pt.plot_waterfall([result], args.plot)
        print(f"plot written to {args.plot}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
