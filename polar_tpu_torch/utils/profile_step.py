"""Where the card's time goes in a Monte-Carlo step.

Profiles, with ``torch.profiler``, steps chained by
:func:`polar_tpu_torch.ber.chain_steps` at -1.5 dB, by default at two
configurations: Polar(1024, 512) systematic int8, B = 32768, 8 steps, and
Polar(131072, 65536) systematic int8, B = 4096, 2 steps (``--configs``
takes others as ``level:batch:steps``, comma-separated). Three steps at
each: the caller's-decoder path with
:func:`~polar_tpu_torch.decode.auto.make_auto_decoder`'s decoder pinned,
once with the kernel draws (``make_step(code, decoder=dec)``) and once
with the torch draws (``fused=False``), then the element-major front step
(:func:`~polar_tpu_torch.ber.make_front_step`, its default branch); at
levels the fused step covers, the fused step too (``fused=True``, the tile
step up to ``step_kernel.STEP_TILE_MAX_LEVEL``).

For each run it prints the host's wall time, the number of device
kernels, and beside it the port's own kernels in the trace (the
functions of ``csrc/``, each in its file's anonymous namespace) against
the launches its wrappers counted in the same run: where the two differ,
the trace lacks a record. Then the device's busy time over the span from
the first kernel's start to the last one's end (and so the idle share),
the device time by kernel and by the torch operator that launched it (the
port's own CUDA kernels are launched through ctypes and show under the
first list only). The shares are of the device-only trace's busy time.

    python -m polar_tpu_torch.utils.profile_step      # one CUDA device
    python -m polar_tpu_torch.utils.profile_step --front-only \
        --configs 14:4096:4,17:4096:2     # the front step alone
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from .profiling import OWN_KERNEL

CONFIGS = ((10, 32768, 8), (17, 4096, 2))   # (level, batch, steps)
SNR_DB = -1.5
TOP = 12


def _rows(totals: dict, busy: float) -> list[str]:
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [f"    {ms:9.3f} ms {100 * ms / busy:5.1f} %  {name[:90]}"
            for name, ms in top]


def profile_steps(multi, gen, batch: int, steps: int) -> list[str]:
    """Profile ``multi(gen, SNR_DB, batch, steps)`` after a warm-up run;
    the lines of its report. Three runs: untraced (the wall time), traced
    on the device only (kernels, busy time, idle share: tracing the host's
    operators too would widen the gaps between launches), and traced with
    the host's operators (device time by operator)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        t0 = time.perf_counter()
        int(multi(gen, SNR_DB, batch, steps)["uncorrected_errors"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()   # warm-up: the first run of a chain on an idle card is slower
    wall = run()
    counters = _launch_counters()
    before = sum(v for c in counters for v in c.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run()
    counted = sum(v for c in counters for v in c.values()) - before
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    own = sum(bool(OWN_KERNEL.match(e.name)) for e in kernels)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_op = {e.key: e.self_device_time_total / 1e3
             for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
             and e.self_device_time_total > 0}
    return ([f"  {steps} steps: wall {wall:.2f} ms untraced, {traced:.2f} ms "
             f"traced; {len(kernels)} kernels, device busy {busy:.2f} of a "
             f"{span:.2f} ms span ({100 * (1 - busy / span):.1f} % idle); "
             f"the port's kernels: {own} in the trace, {counted} launches "
             f"counted",
             "  by kernel:"] + _rows(by_kernel, busy)
            + ["  by torch operator (self device time, traced with the "
               "host's operators):"] + _rows(by_op, busy))


def _launch_counters() -> list:
    """The launch counters of every kernel wrapper (``launches`` and, for
    ``step_kernel``, ``earlier_launches``: the walk and the thread front,
    run above the tile kernels' levels)."""
    from ..ops.cuda import (channel_kernel, count_kernel, decoder_kernel,
                            encode_kernel, front_kernel, interp_kernel,
                            ring_kernel, step_kernel, subtree_kernel)

    mods = (channel_kernel, count_kernel, decoder_kernel, encode_kernel,
            front_kernel, interp_kernel, ring_kernel, step_kernel,
            subtree_kernel)
    return [c for mod in mods
            for c in (mod.launches, getattr(mod, "earlier_launches", None))
            if c is not None]


def _configs(text: str) -> tuple:
    return tuple(tuple(int(x) for x in item.split(":"))
                 for item in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", type=_configs, default=CONFIGS,
                    help="level:batch:steps, comma-separated")
    ap.add_argument("--front-only", action="store_true",
                    help="profile the front step alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    import polar_tpu_torch as pt
    from polar_tpu_torch.ber import (STEP_KERNEL_MAX_LEVEL, chain_steps,
                                     front_branch, make_front_step)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    for level, batch, steps in args.configs:
        code = pt.make_code(level, rate=0.5)
        runs = []
        if not args.front_only:
            dec, desc = pt.make_auto_decoder(code, output="systematic",
                                             device=dev)
            runs = [(f"{desc}, {label}", pt.make_step(code, decoder=dec,
                                                      fused=fused, device=dev))
                    for label, fused in (("kernel draws", "auto"),
                                         ("torch draws", False))]
        runs.append((f"front step, {front_branch(code, True)} branch",
                     make_front_step(code, device=dev)))
        if level <= STEP_KERNEL_MAX_LEVEL and not args.front_only:
            runs.append(("fused step", pt.make_step(code, fused=True,
                                                    device=dev)))
        for label, step in runs:
            gen = torch.Generator()
            gen.manual_seed(level)
            multi = chain_steps(step)
            print(f"Polar({code.N}, {code.K}) B={batch}, {label}, "
                  f"{SNR_DB} dB:", flush=True)
            for line in profile_steps(multi, gen, batch, steps):
                print(line, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
