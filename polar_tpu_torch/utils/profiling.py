"""Profiling and tracing helpers, the port of ``polar_tpu.utils.profiling``.

* :func:`trace` — a context manager around ``torch.profiler.profile``
  that records host (CPU) activity, and the card's (CUDA) activity where a
  card is present, and writes a Chrome/Perfetto trace into ``log_dir``;
* :func:`annotate` — the program's span: a named range of the host's
  ``time.perf_counter_ns`` clock, recorded while any ``torch.profiler``
  session runs (inside :func:`trace` also a ``record_function`` range that
  shows in the trace file), and a shared no-op otherwise;
* :func:`begin` / :func:`launched` — a kernel wrapper's launch counter and
  its span ``kernel.<key>``, from the wrapper's entry to its last C call's
  return, recorded together;
* :func:`take_spans` — the spans recorded so far, as
  ``(name, start ns, end ns, parent index)``.

The recorder follows the profiler: it has no switch of its own. It keeps
at most :data:`MAX_SPANS` spans between two :func:`take_spans` calls and
counts the ones beyond. Spans nest on one host thread.

The program's spans: ``run_point``, ``run_point.step`` and
``run_point.pull`` (``ber.run_point``); ``step.seeds`` (a step's Philox
key draw), ``step.unpack`` (the counters' views) and ``step.count`` (the
five counters' torch work in ``ber.make_step_body``'s step);
``decode``, ``decode.transpose_in`` and ``decode.transpose_out`` (the
frame-major decode entries); ``kernel.<key>`` in every launching wrapper.
Beside the wrappers' launch counters, ``ber.steps_by_path`` counts the
steps run by the path that ran them.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

DEFAULT_LOG_DIR = Path(__file__).resolve().parents[2] / "build" / "traces"
# a kernel of csrc/: every one sits in a file's own anonymous namespace
# (torch's sit in at::native's), demangled or not
OWN_KERNEL = re.compile(r"(void )?\(anonymous namespace\)::|_ZN\d+_GLOBAL__N_")
MAX_SPANS = 1 << 21

_OFF = contextlib.nullcontext()
# the spans as four lists of plain values, which add nothing for the
# garbage collector to walk however long they grow
_names: list = []
_starts: list = []
_ends: list = []
_parents: list = []
_open: list = []        # the entered annotate spans, innermost last
_dropped = 0
_traced = 0             # trace() sessions open


@contextlib.contextmanager
def trace(log_dir=DEFAULT_LOG_DIR):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    session, whose ``trace_file`` attribute names the trace it writes
    into ``log_dir`` on exit (the process and the clock in its name, so
    sessions never overwrite each other). Load the file in Perfetto
    (ui.perfetto.dev) or ``chrome://tracing``."""
    global _traced
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        prof.trace_file = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
        _traced += 1
        try:
            yield prof
        finally:
            _traced -= 1
    prof.export_chrome_trace(str(prof.trace_file))


def _append(name: str, start: int, end: int) -> int:
    """Add a span, its parent the innermost open span of the current
    buffer; its index, or -1 where the buffer is full."""
    global _dropped
    index = len(_names)
    if index >= MAX_SPANS:
        _dropped += 1
        return -1
    _names.append(name)
    _starts.append(start)
    _ends.append(end)
    _parents.append(_open[-1].index if _open and _open[-1].ends is _ends
                    else -1)
    return index


class _Span:
    __slots__ = ("name", "ends", "index", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _traced:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.ends = _ends
        self.index = _append(self.name, time.perf_counter_ns(), 0)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        if self.index >= 0:
            self.ends[self.index] = end
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str):
    """The span ``name`` around the enclosed block while a profiler
    session runs; else one shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def begin() -> int | None:
    """A kernel wrapper's entry: the host clock while recording, else
    None; hand it to :func:`launched`."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return time.perf_counter_ns()


def launched(start: int | None, counts: dict, key: str, n: int = 1) -> None:
    """Count ``n`` launches under ``key`` in a wrapper's ``counts`` and,
    when ``start`` came from :func:`begin` while recording, record the
    span ``kernel.<key>`` from ``start`` to now (its parent the innermost
    open :func:`annotate` span)."""
    counts[key] += n
    if start is not None:
        _append("kernel." + key, start, time.perf_counter_ns())


def take_spans() -> tuple[list[tuple[str, int, int, int]], int]:
    """``(spans, dropped)``: the spans recorded since the last call, each
    ``(name, start ns, end ns, parent index)`` on ``time.perf_counter_ns``
    (a span still open has end 0; parent -1 at the top), and how many did
    not fit; the buffer starts again empty."""
    global _names, _starts, _ends, _parents, _dropped
    spans = list(zip(_names, _starts, _ends, _parents))
    dropped = _dropped
    _names, _starts, _ends, _parents, _dropped = [], [], [], [], 0
    return spans, dropped


def trace_events(path) -> list[dict]:
    """The events of a trace file :func:`trace` wrote."""
    return json.loads(Path(path).read_text())["traceEvents"]


def own_kernels(path) -> list[str]:
    """The names of the port's own CUDA kernels (``csrc/``) the trace file
    recorded, one a launch."""
    return [e["name"] for e in trace_events(path)
            if e.get("cat") == "kernel" and OWN_KERNEL.match(e.get("name", ""))]
