"""Phase probe of the block front's kernel B on one CUDA device.

Builds ``csrc/probe/chan_phases.cu`` (kernel B's own code with parts of
its work switched off: the row I/O alone, the draw with and without the
LLR stores) with the library's nvcc flags, runs it and prints the card
and one line per variant, ms a launch by CUDA events, beside kernel B as
built. Needs nvcc (``ops/cuda/build.py:find_nvcc``):

    python -m polar_tpu_torch.utils.front_probe [--m 17] [--batch 4096]
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from ..ops.cuda import build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=17)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--blk", type=int, default=1 << 10)
    args = ap.parse_args(argv)
    src = build.CSRC_DIR / "probe" / "chan_phases.cu"
    out = build.BUILD_DIR / "probe" / "chan_phases"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    return subprocess.run([str(out), str(args.m), str(args.batch),
                           str(args.blk)]).returncode


if __name__ == "__main__":
    sys.exit(main())
