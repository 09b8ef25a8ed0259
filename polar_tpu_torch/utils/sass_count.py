"""Static SASS instruction counts of the port's CUDA kernels.

Builds the kernels' library if needed (``ops/cuda/build.py``), runs the
toolkit's ``cuobjdump -sass`` on it and counts, for every kernel function
whose name holds one of the given substrings, its instructions (NOPs
apart) and its most frequent opcodes. A straight-line kernel's count over
the elements a thread takes is its instructions per element; times the
elements over the card's instruction rate it gives the instruction-rate
floor of a launch. Needs the CUDA toolkit (``cuobjdump`` beside ``nvcc``):

    python -m polar_tpu_torch.utils.sass_count awgn encode_bits
    python -m polar_tpu_torch.utils.sass_count front_msg front_chan

prints one JSON line per function (the block front's kernels A and B:
``front_msg_rows_kernel`` / ``front_chan_rows_kernel``, one instance each
for blocks of at least four rows and for smaller ones).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

from ..ops.cuda import build

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(build.find_nvcc()).parent / name)


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("cu++filt") or str(
        Path(build.find_nvcc()).parent / "cu++filt")
    if not Path(tool).is_file():
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def count(library: Path, patterns: list[str]) -> list[dict]:
    """Per matching kernel function: its instruction count (NOPs apart)
    and its ten most frequent opcodes."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current[m.group(1)] += 1
    names = _demangle(list(funcs))
    rows = []
    for mangled, ops in funcs.items():
        name = names[mangled]
        if patterns and not any(p in name or p in mangled for p in patterns):
            continue
        total = sum(n for op, n in ops.items() if op != "NOP")
        rows.append({"function": name, "instructions": total,
                     "top_opcodes": ops.most_common(10)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("patterns", nargs="*",
                    help="substrings of the kernel names (default: all)")
    args = ap.parse_args(argv)
    for row in count(build.build(), args.patterns):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
