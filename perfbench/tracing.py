"""The traced run's device trace: one ``torch.profiler`` session over the
window, on the card's activity only (kernels, copies, fills).

From the trace it reads the device's busy time (the union of the
activity intervals), the device operations that took most time, and the
longest gaps with nothing on the card, each named by the benchmark's own
host span (:class:`harness.Spans`) the host was in when the gap began. The
trace's clock is matched to the host's by a marker kernel launched just
before the window. The session counts the program's own kernels in the
trace (a kernel of ``csrc/`` sits in a file's anonymous namespace) against
the launches the program's wrappers counted: a session that recorded none
of them raises, and no idle share or roofline is read from it.
"""

from __future__ import annotations

import bisect
import re
import sys
import time

OWN_KERNEL = re.compile(r"(void )?\(anonymous namespace\)::|_ZN\d+_GLOBAL__N_")
TOP = 10


class TraceError(RuntimeError):
    """The profiler session recorded nothing to read."""


def program_launches() -> int:
    """The launches the program's kernel wrappers have counted so far
    (their ``launches`` and ``earlier_launches`` counters)."""
    total = 0
    for name, mod in list(sys.modules.items()):
        if name.startswith("polar_tpu_torch.ops.cuda.") and mod is not None:
            for attr in ("launches", "earlier_launches"):
                counts = getattr(mod, attr, None)
                if isinstance(counts, dict):
                    total += sum(counts.values())
    return total


def union(intervals) -> tuple[float, list[tuple[int, int]]]:
    """(covered ns, merged intervals) of (start, end) ns pairs."""
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [tuple(m) for m in merged]


class SpanIndex:
    """Finds the innermost host span holding a time: for each span name
    its spans sorted by start, the latest-starting one that holds it."""

    def __init__(self, spans):
        by_name: dict = {}
        for name, a, b in spans:
            by_name.setdefault(name, []).append((a, b))
        self.by_name = {n: (sorted(v), [a for a, _ in sorted(v)])
                        for n, v in by_name.items()}

    def at(self, t: int) -> str:
        best, start = "between spans", None
        for name, (items, starts) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < items[i][1] and (start is None
                                               or items[i][0] > start):
                best, start = name, items[i][0]
        return best


def summarize(events, window: tuple[int, int], spans, launches: int) -> dict:
    """The trace's numbers: ``events`` are (name, start, end) device
    activities in host ns, ``window`` the host's (start, end) ns."""
    w0, w1 = window
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in events
              if b > w0 and a < w1]
    own = sum(bool(OWN_KERNEL.match(n)) for n, _, _ in inside)
    if not inside:
        raise TraceError("the profiler recorded no device activity")
    if launches and not own:
        raise TraceError(f"the profiler recorded none of the program's "
                         f"{launches} launches")
    busy, merged = union((a, b) for _, a, b in inside)
    by_name: dict = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0) + (b - a)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    index = SpanIndex(spans)
    idle_by_span: dict = {}
    for a, b in gaps:
        name = index.at(a)
        idle_by_span[name] = idle_by_span.get(name, 0) + (b - a)
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[n[:120], t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[index.at(a), (b - a) / 1e9]
                      for a, b in gaps[:TOP]],
        "idle_by_span": {k: v / 1e9 for k, v in idle_by_span.items()},
        "activities": len(inside),
        "own_kernels": own,
        "launches": launches,
    }


def _activity(prof):
    """(name, start ns, end ns) of every device activity of the session,
    in the trace's clock."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        out = []
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA:
                start = e.start_ns()
                out.append((e.name(), start, start + e.duration_ns()))
        return out
    return [(e.name, int(e.time_range.start * 1000),
             int(e.time_range.end * 1000)) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class Trace:
    """``with Trace(device, enabled):`` around the window; ``summary`` then
    gives :func:`summarize`'s numbers in the host's clock."""

    def __init__(self, device, enabled: bool):
        self.device = device
        self.enabled = enabled and device.type == "cuda"
        self.prof = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.launches0 = program_launches()
        self.marks = (time.perf_counter_ns(), time.monotonic_ns(),
                      time.time_ns())
        torch.ones(1, device=self.device).add_(1)     # the marker kernel
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        torch.cuda.synchronize(self.device)
        self.launches = program_launches() - self.launches0
        self.prof.__exit__(*exc)
        return False

    def summary(self, window: tuple[int, int], spans) -> dict:
        """The numbers of the ``window`` (host perf_counter ns), or a
        :class:`TraceError`."""
        if not self.enabled:
            raise TraceError("no trace on a CPU run")
        events = sorted(_activity(self.prof), key=lambda e: e[1])
        if not events:
            raise TraceError("the profiler recorded no device activity")
        marker = events[0][1]
        perf = self.marks[0]
        # the host clock the trace keeps, else the marker taken as launched
        # at the host's mark
        clocks = [c for c, mark in zip(("perf_counter", "monotonic", "time"),
                                       self.marks)
                  if 0 <= marker - mark < 10**9]
        shift = (self.marks[("perf_counter", "monotonic", "time").index(
            clocks[0])] - perf) if clocks else marker - perf
        events = [(n, a - shift, b - shift) for n, a, b in events[1:]]
        out = summarize(events, window, spans.items, self.launches)
        out["clock"] = clocks[0] if clocks else "marker"
        return out
