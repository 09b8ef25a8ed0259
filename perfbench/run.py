"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the repository's root; its
configuration, traffic mix, traffic kind and per-layer metrics are files
under this folder (see ``harness.py`` and ``README.md``). The last line of
standard output is one JSON object; the numbers compared for ``correct``
are also the last lines of standard error, each beside its limit. The run
exits with 1 and prints no result where there is no card, too few cards,
a missing piece, or a forbidden module (``jax``, ``jaxlib``, ``flax``,
``polar_tpu``) loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(REPO)]
    import harness
    from tracing import TraceError

    try:
        out = harness.run(harness.Bench.from_file(REPO / "BENCHMARK.json"),
                          args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except (harness.BenchError, TraceError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"perfbench: the program cannot be loaded: {e}",
              file=sys.stderr)
        return 1
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
