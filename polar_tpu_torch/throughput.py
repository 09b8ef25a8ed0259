"""Decode frames/s per code length: the port of ``scripts/throughput.py``.

For each ``--ms`` level it times the auto-selected decoder
(:func:`polar_tpu_torch.make_auto_decoder`: on a card the scratch style,
the tile kernel or the interpreter by level and batch) with the chained
slope method (:func:`polar_tpu_torch.utils.benchmark.measure_decode_fps`)
on full-range int8 LLRs from ``numpy.random.default_rng(5)``, at batch
``max(1024, min(131072, 2**25 // N))``, and prints one row a level: the
decoder's description and its frames/s. ``--with-eager`` adds the eager
Fast-SSC decoder (the JAX script's ``--with-xla`` column). The AVX2
reference column of the JAX script needs the reference's sources, which
this package does not carry; it is left out. Runs on ``--device``
(default ``cuda``); ``--cpu`` is for the tests.

  python -m polar_tpu_torch.throughput --ms 6 8 10 12 14
"""

from __future__ import annotations

import argparse
import sys


def batch_for(n: int) -> int:
    """The JAX script's batch at code length ``n``."""
    return max(1024, min(131072, (1 << 25) // n))


def inputs(rng, ms, device):
    """(code, llrs) a level, in order: Polar(2^m, 2^(m-1)) and its (B, N)
    full-range int8 LLRs drawn from ``rng``, B by :func:`batch_for`."""
    import numpy as np
    import torch

    import polar_tpu_torch as pt

    for m in ms:
        code = pt.make_code(m, rate=0.5)
        yield code, torch.from_numpy(rng.integers(
            -128, 128, (batch_for(code.N), code.N)).astype(np.int8)).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ms", type=int, nargs="+", default=[6, 8, 10, 12, 14])
    ap.add_argument("--with-eager", action="store_true",
                    help="also time the eager Fast-SSC decoder")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.utils.benchmark import measure_decode_fps

    device = torch.device("cpu" if args.cpu else args.device)
    for code, llrs in inputs(np.random.default_rng(5), args.ms, device):
        dec, desc = pt.make_auto_decoder(code, device=device)
        row = f"N={code.N:6d} [{desc}]"
        try:
            fps = measure_decode_fps(dec, llrs, iters=args.iters)
            row += f" {fps:14,.0f} frames/s"
        except Exception as e:
            row += f" FAILED ({type(e).__name__})"
        if args.with_eager:
            try:
                fps = measure_decode_fps(
                    pt.make_fastssc_decoder(code, output_dtype=torch.int8),
                    llrs, iters=args.iters)
                row += f" | eager {fps:14,.0f}"
            except Exception as e:
                row += f" | eager FAILED ({type(e).__name__})"
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
