"""Profiling and tracing helpers, the port of ``polar_tpu.utils.profiling``.

* :func:`trace` — a context manager around ``torch.profiler.profile``
  that records host (CPU) activity, and the card's (CUDA) activity where a
  card is present, and writes a Chrome/Perfetto trace into ``log_dir``;
* :func:`annotate` — a named range (``torch.profiler.record_function``)
  that shows in the trace, for marking campaign phases.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEFAULT_LOG_DIR = Path(__file__).resolve().parents[2] / "build" / "traces"
# a kernel of csrc/: every one sits in a file's own anonymous namespace
# (torch's sit in at::native's), demangled or not
OWN_KERNEL = re.compile(r"(void )?\(anonymous namespace\)::|_ZN\d+_GLOBAL__N_")


@contextlib.contextmanager
def trace(log_dir=DEFAULT_LOG_DIR):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    session, whose ``trace_file`` attribute names the trace it writes
    into ``log_dir`` on exit (the process and the clock in its name, so
    sessions never overwrite each other). Load the file in Perfetto
    (ui.perfetto.dev) or ``chrome://tracing``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        prof.trace_file = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
        yield prof
    prof.export_chrome_trace(str(prof.trace_file))


def annotate(name: str):
    """A named range visible in profiler timelines."""
    return record_function(name)


def trace_events(path) -> list[dict]:
    """The events of a trace file :func:`trace` wrote."""
    return json.loads(Path(path).read_text())["traceEvents"]


def own_kernels(path) -> list[str]:
    """The names of the port's own CUDA kernels (``csrc/``) the trace file
    recorded, one a launch."""
    return [e["name"] for e in trace_events(path)
            if e.get("cat") == "kernel" and OWN_KERNEL.match(e.get("name", ""))]
