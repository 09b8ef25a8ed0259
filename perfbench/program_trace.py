"""The program's own spans and launch counters joined with the traced run's
device trace, on the host's clock.

The program (``polar_tpu_torch.utils.profiling``) records spans while a
profiler session runs: ``run_point``, ``run_point.step``,
``run_point.pull``, ``step.seeds``, ``step.unpack``, ``decode``,
``decode.transpose_in``, ``decode.transpose_out`` and one
``kernel.<key>`` a launching wrapper call, each ``(name, start ns, end
ns, parent)`` on ``time.perf_counter_ns``, the clock of the benchmark's
window. :func:`read` takes them (``take_spans()``) after the traced
window and puts the session's device activity on the same clock by the
marker shift of :meth:`tracing.Trace.summary`. It gives:

* ``idle_by_span``: every idle gap of the window, split over the
  innermost program span that covers each part of it (its self time);
  idle outside every program span is ``outside``;
* ``device_by_span``: each device activity's time, given to the innermost
  program span around the host call that launched it (the runtime API
  record of the same correlation id); ``outside`` where that call lay in
  no span, ``unmatched`` where the session holds no such record;
* three counts of the window's launches: ``launches`` (the program's
  counters), ``own_kernels`` (the trace's records of the program's
  kernels) and ``runtime_launches`` (the runtime's launch records made
  inside a ``kernel.*`` span). Equal counts mean the session dropped no
  record.

A program without the recorder (``take_spans`` missing) gives ``None``.
The harness keeps its traced session (a :class:`tracing.Trace`) in the
frame that calls the per-layer readers; :func:`of` finds it there once a
run and leaves the result in ``run["program"]`` for the readers after it.
"""

from __future__ import annotations

import bisect
import json
import sys

import tracing

OUTSIDE = "outside"
UNMATCHED = "unmatched"
KERNEL = "kernel."


def _take_spans():
    """The program's spans and drops, or ``None`` without a recorder."""
    mod = sys.modules.get("polar_tpu_torch.utils.profiling")
    take = getattr(mod, "take_spans", None)
    return None if take is None else take()


def self_segments(spans) -> list[tuple[int, int, str]]:
    """``(start, end, name)`` of each stretch of host time and the
    innermost span that holds it, in order, from nested ``(name, start,
    end, ...)`` spans; open spans (end 0) and empty ones are left out."""
    items = sorted(((s[1], s[2], s[0]) for s in spans if s[2] > s[1]),
                   key=lambda s: (s[0], -s[1]))
    out: list = []
    stack: list = []        # (end, name), innermost last
    cursor = 0

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, b, name in items:
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            emit(cursor, end, inner)
            cursor = end
        if stack:
            emit(cursor, a, stack[-1][1])
        stack.append((b, name))
        cursor = a
    while stack:
        end, inner = stack.pop()
        emit(cursor, end, inner)
        cursor = max(cursor, end)
    return out


class SelfIndex:
    """The innermost program span at a host time, and the split of an
    interval over the spans by self time."""

    def __init__(self, spans):
        self.segments = self_segments(spans)
        self.ends = [b for _, b, _ in self.segments]

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.ends, t)
        if i < len(self.segments) and self.segments[i][0] <= t:
            return self.segments[i][2]
        return OUTSIDE

    def split(self, a: int, b: int, into: dict) -> None:
        """Add the ns of ``[a, b)`` to ``into`` by innermost span."""
        i = bisect.bisect_right(self.ends, a)
        covered = 0
        while i < len(self.segments) and self.segments[i][0] < b:
            s0, s1, name = self.segments[i]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                into[name] = into.get(name, 0) + part
                covered += part
            i += 1
        if b - a > covered:
            into[OUTSIDE] = into.get(OUTSIDE, 0) + (b - a - covered)


def join(device, runtime, spans, window, launches: int) -> dict:
    """The join on one clock (host ns): ``device`` are ``(name, start,
    end, correlation id)`` activities, ``runtime`` ``(name, start,
    correlation id)`` host API records, ``spans`` the program's, ``window``
    the host's ``(start, end)``, ``launches`` the counters' launches."""
    w0, w1 = window
    inside = [(n, max(a, w0), min(b, w1), c) for n, a, b, c in device
              if b > w0 and a < w1]
    _, merged = tracing.union((a, b) for _, a, b, _ in inside)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    index = SelfIndex(spans)
    idle: dict = {}
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            index.split(edges[i], edges[i + 1], idle)
    launched_at = {c: t for n, t, c in runtime}
    by_span: dict = {}
    for _, a, b, c in inside:
        t = launched_at.get(c)
        name = UNMATCHED if t is None else index.at(t)
        by_span[name] = by_span.get(name, 0) + (b - a)
    own = sum(bool(tracing.OWN_KERNEL.match(n)) for n, _, _, _ in inside)
    in_kernel = sum("Launch" in n and w0 <= t < w1
                    and index.at(t).startswith(KERNEL)
                    for n, t, _ in runtime)
    return {
        "idle_by_span": {k: v / 1e9 for k, v in sorted(idle.items())},
        "device_by_span": {k: v / 1e9 for k, v in sorted(by_span.items())},
        "launches": launches,
        "own_kernels": own,
        "runtime_launches": in_kernel,
    }


def _records(prof):
    """``(device, runtime)``: the session's device activities ``(name,
    start, end, correlation id)`` and its host-side CUDA API records
    ``(name, start, correlation id)``, in the trace's clock."""
    from torch.autograd import DeviceType

    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, start + e.duration_ns(),
                           e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime.append((e.name(), start, e.correlation_id()))
    return device, runtime


def _shift(tracer, marker: int) -> int:
    """The trace clock's offset from ``perf_counter``, as
    :meth:`tracing.Trace.summary` finds it from the marker kernel."""
    names = ("perf_counter", "monotonic", "time")
    clocks = [c for c, mark in zip(names, tracer.marks)
              if 0 <= marker - mark < 10**9]
    perf = tracer.marks[0]
    return (tracer.marks[names.index(clocks[0])] - perf) if clocks \
        else marker - perf


def read(tracer, window: tuple[int, int], attempted: int):
    """The join of a traced run, or ``None`` where the run was not traced
    or the program has no recorder."""
    if tracer is None or not tracer.enabled or tracer.prof is None:
        return None
    taken = _take_spans()
    if taken is None:
        return None
    spans, dropped = taken
    device, runtime = _records(tracer.prof)
    if not device:
        return None
    marker = min(a for _, a, _, _ in device)
    shift = _shift(tracer, marker)
    device = [(n, a - shift, b - shift, c) for n, a, b, c in device
              if a != marker]
    runtime = [(n, t - shift, c) for n, t, c in runtime]
    out = join(device, runtime, spans, window, tracer.launches)
    out.update(spans=len(spans), dropped=dropped, calls=attempted)
    return out


def _session():
    """The harness's traced session: the :class:`tracing.Trace` in a
    calling frame, or ``None``."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, tracing.Trace):
                return value
        frame = frame.f_back
    return None


def of(run: dict):
    """The join of the run whose record is ``run`` (computed by the first
    reader that asks, with one line of it on standard error), or
    ``None``."""
    if "program" not in run:
        run["program"] = (read(_session(), run["window_ns"], run["attempted"])
                          if run.get("trace") else None)
        if run["program"] is not None:
            print("perfbench: program: " + json.dumps(run["program"]),
                  file=sys.stderr, flush=True)
    return run["program"]


def per_call_ms(run: dict, idle_of) -> float | None:
    """The idle of the spans ``idle_of(name)`` picks, in ms a call."""
    program = of(run)
    if program is None or not run["attempted"]:
        return None
    idle = sum(v for k, v in program["idle_by_span"].items() if idle_of(k))
    return 1e3 * idle / run["attempted"]
