"""The reference's curve set of BER waterfalls: the port of
``scripts/curve_set.py``.

"Comparing various systematic and non-systematic rate-1/2 code lengths"
(the reference's README): one campaign per (N, mode) pair through
:func:`polar_tpu_torch.run_campaign`, each checkpointed to
``<outdir>/<tag>.json`` so the sweep resumes where it stopped, the
combined plot rewritten after every campaign. Tags are
``n<N>_{sys,nonsys}_int8_torch<suffix>`` and the default ``--outdir`` is
``results/torch``, so no result file of the JAX package is ever written.
``--plot ""`` skips the plot (matplotlib is needed only for it, and is
looked for before the first campaign starts). Runs on ``--device``
(default ``cuda``); ``--cpu`` is for the tests.

  python -m polar_tpu_torch.curve_set                    # m = 6 8 10 12 14
  python -m polar_tpu_torch.curve_set --ms 8 10 --plot ""
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

DEFAULT_OUTDIR = Path("results") / "torch"


def tag(m: int, systematic: bool, suffix: str = "") -> str:
    """A campaign's checkpoint name (without ``.json``)."""
    return f"n{1 << m}_{'sys' if systematic else 'nonsys'}_int8_torch{suffix}"


def device_title(device) -> str:
    """The plot title, naming the card (or the CPU)."""
    import torch

    device = torch.device(device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    return f"polar_tpu_torch BER waterfalls, rate-1/2 ({where})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ms", type=int, nargs="+", default=[6, 8, 10, 12, 14])
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-frames", type=int, default=1 << 14)
    ap.add_argument("--target-errors", type=int, default=1000)
    ap.add_argument("--snr-step", type=float, default=0.2)
    ap.add_argument("--snr-min", type=float, default=None,
                    help="first SNR point (default: the campaign's)")
    ap.add_argument("--snr-max", type=float, default=None,
                    help="last SNR point (default: the campaign's)")
    ap.add_argument("--outdir", type=str, default=str(DEFAULT_OUTDIR))
    ap.add_argument("--plot", type=str, default=None,
                    help='PNG path (default <outdir>/ber_log_torch.png; "" '
                         "for no plot)")
    ap.add_argument("--steps-per-call", type=int, default=1)
    ap.add_argument("--tag-suffix", type=str, default="",
                    help="append to checkpoint names (fresh files for a "
                         "deeper re-run without clobbering earlier ones)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)

    outdir = Path(args.outdir)
    plot = (str(outdir / "ber_log_torch.png") if args.plot is None
            else args.plot)
    if plot:
        import matplotlib  # noqa: F401  (before any campaign: the plot needs it)

    import polar_tpu_torch as pt
    from polar_tpu_torch.campaign_io import plot_waterfall

    device = "cpu" if args.cpu else args.device
    snr_range = None
    if args.snr_min is not None or args.snr_max is not None:
        if args.snr_min is None or args.snr_max is None:
            ap.error("--snr-min and --snr-max go together")
        snr_range = (args.snr_min, args.snr_max)
    outdir.mkdir(parents=True, exist_ok=True)
    results = []
    for m in args.ms:
        for systematic in (True, False):
            name = tag(m, systematic, args.tag_suffix)
            print(f"=== {name} ===", file=sys.stderr, flush=True)
            code = pt.make_code(m, rate=args.rate)
            res = pt.run_campaign(
                code,
                systematic=systematic,
                batch=min(args.batch, max(512, (1 << 22) // code.N)),
                max_frames_per_point=args.max_frames,
                target_bit_errors=args.target_errors,
                snr_range=snr_range,
                snr_step=args.snr_step,
                measure_throughput=False,
                verbose=True,
                checkpoint_path=outdir / f"{name}.json",
                steps_per_call=args.steps_per_call,
                device=device,
            )
            results.append(res)
            if plot:
                plot_waterfall(results, plot, title=device_title(device))
    print(f"curve set complete: {len(results)} campaigns in {outdir}"
          + (f", plot at {plot}" if plot else ""), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
