"""The benchmark's harness: finds a cell's pieces by name and runs it once.

Everything that belongs to one configuration, one traffic mix, one kind of
traffic or one per-layer metric sits in a file of its own under this
folder, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json`` — a code as it is run (its source and the
  keys changed from it);
* ``traffic/<traffic>.json`` — a traffic mix: the parameters that its
  ``kind`` reads (batch, SNR, calls in flight, ...);
* ``kinds/<kind>.py`` — the generator of one kind of traffic: it builds
  the program's entry for the cell, warms it, drives it for the window and
  checks its answers against the plain reference (``reference/``);
* ``metrics/<metric>.py`` — the reader of one per-layer metric, ``read(run)``
  on the run's record, returning a number or ``None`` where it finds
  nothing to read.

A run prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, every number compared beside its limit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "polar_tpu")


class BenchError(RuntimeError):
    """The run cannot produce a result (no card, a missing piece)."""


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _load_module(path: Path):
    """A module from a file whose name may hold dots."""
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the pieces under ``root`` it names."""

    def __init__(self, spec: dict, root: Path = HERE):
        self.spec = spec
        self.root = Path(root)

    @classmethod
    def from_file(cls, path: Path, root: Path = HERE) -> "Bench":
        if not Path(path).is_file():
            raise BenchError(f"no {path}")
        return cls(json.loads(Path(path).read_text()), root)

    def _json(self, folder: str, name: str) -> dict:
        path = self.root / folder / f"{name}.json"
        if not path.is_file():
            raise BenchError(f"no file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def kind(self, name: str):
        return _load_module(self.root / "kinds" / f"{name}.py")

    def reader(self, metric: str):
        return _load_module(self.root / "metrics" / f"{metric}.py")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


class Spans:
    """Host-clock spans of the benchmark's own, around its calls into the
    program: ``with spans("name"):`` records (name, start ns, end ns)."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    def __call__(self, name: str):
        return _Span(self.items, name)

    def seconds(self, name: str) -> list[float]:
        return [(b - a) / 1e9 for n, a, b in self.items if n == name]


class _Span:
    __slots__ = ("items", "name", "t0")

    def __init__(self, items, name):
        self.items, self.name = items, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.items.append((self.name, self.t0, time.perf_counter_ns()))


def note(text: str) -> None:
    """A line of the run's account on standard error."""
    print(f"perfbench: {text}", file=sys.stderr, flush=True)


def _device(chips: int, device):
    """The device to run on, after the look for enough cards."""
    import torch

    if device != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def run(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
        *, t_start: float, device: str = "cuda", wrap=None) -> dict:
    """Run one cell once; returns the result line's object. ``wrap`` puts
    another callable in place of the program's timed entry (the control and
    the planted faults of the tests); the runs of the benchmark pass none."""
    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    kind = bench.kind(mix["kind"])
    e2e = bench.end_to_end(workload)
    layers = bench.per_layer(workload)
    readers = {m["name"]: bench.reader(m["name"]) for m in layers}
    dev = _device(cell["chips"], device)

    import torch

    from tracing import Trace

    t_prepare = time.perf_counter()
    runner = kind.prepare(config, mix, seed, dev, wrap=wrap)
    spans = Spans()
    tracer = Trace(dev, enabled=trace)
    setup_s = time.perf_counter() - t_start
    phases = {"to_prepare": t_prepare - t_start,
              **getattr(runner, "phases", {})}
    note("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    with tracer:
        record = runner.window(seconds, spans)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record["spans"] = spans
    record["trace"] = (tracer.summary(record["window_ns"], spans) if trace
                       else None)
    runner.release()
    t_check = time.perf_counter()
    checks, failed = runner.check()
    note(f"{workload}: {record['attempted']} calls in {record['window_s']:.3f}"
         f" s; reference check {time.perf_counter() - t_check:.2f} s")
    if trace:
        note("trace: " + json.dumps({k: v for k, v in record["trace"].items()
                                     if k not in ("device_ops",)}))
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if trace:
        for m in layers:
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(record["metrics"], setup_s=setup_s)
        for m in e2e:
            if m["name"] not in values:
                raise BenchError(f"{mix['kind']} gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {
        "correct": correct,
        "attempted": record["attempted"],
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        t = record["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in checks.items()}
    # after the window and the check: a module once loaded stays listed
    found = forbidden_modules()
    if found:
        raise BenchError("forbidden modules loaded: " + ", ".join(found))
    return out
