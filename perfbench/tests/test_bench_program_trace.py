"""The join of the program's spans with the device trace, on synthetic
spans and device activity with exact answers: idle split by self time,
``outside``, device time by launching span through correlation ids, the
three launch counts, the readers, and a program without a recorder."""

import sys
import types

import pytest

import harness
import program_trace
import tracing

OWN = "void (anonymous namespace)::count_rows_kernel<true>(...)"
TORCH = "void at::native::elementwise_kernel<128, 4, ...>(...)"
COPY = "Memcpy DtoH (Device -> Pageable)"

# one campaign call on a 1000 ns window: (name, start, end, parent)
SPANS = [("run_point", 0, 900, -1), ("run_point.step", 10, 300, 0),
         ("step.seeds", 20, 40, 1), ("run_point.pull", 300, 600, 0),
         ("kernel.count", 50, 100, 1)]
# (name, start, end, correlation id); the copy's runtime record is missing
DEVICE = [(OWN, 30, 80, 1), (TORCH, 150, 400, 2), (OWN, 700, 950, 3),
          (COPY, 960, 980, 4)]
RUNTIME = [("cudaLaunchKernel", 60, 1), ("cudaLaunchKernel", 350, 2),
           ("cudaStreamSynchronize", 500, 9),
           ("cudaLaunchCooperativeKernel", 650, 3)]
WINDOW = (0, 1000)


def ns(x):
    return pytest.approx(x * 1e-9)


def test_self_segments_give_each_stretch_its_innermost_span():
    assert program_trace.self_segments(SPANS) == [
        (0, 10, "run_point"), (10, 20, "run_point.step"),
        (20, 40, "step.seeds"), (40, 50, "run_point.step"),
        (50, 100, "kernel.count"), (100, 300, "run_point.step"),
        (300, 600, "run_point.pull"), (600, 900, "run_point")]
    index = program_trace.SelfIndex(SPANS)
    assert [index.at(t) for t in (0, 15, 50, 99, 300, 899, 900, -5)] == [
        "run_point", "run_point.step", "kernel.count", "kernel.count",
        "run_point.pull", "run_point", "outside", "outside"]


def test_open_and_empty_spans_are_left_out():
    spans = [("decode", 100, 0, -1), ("x", 5, 5, -1), ("y", 5, 9, -1)]
    assert program_trace.self_segments(spans) == [(5, 9, "y")]


def test_idle_is_split_by_self_time_and_outside():
    out = program_trace.join(DEVICE, RUNTIME, SPANS, WINDOW, launches=2)
    # busy [30,80) [150,400) [700,950) [960,980): 570 ns; idle 430 ns:
    # [0,30) run_point 10, step 10, seeds 10; [80,150) kernel 20, step 50;
    # [400,700) pull 200, run_point 100; [950,960) [980,1000) outside 30
    assert out["idle_by_span"] == {
        "kernel.count": ns(20), "outside": ns(30), "run_point": ns(110),
        "run_point.pull": ns(200), "run_point.step": ns(60),
        "step.seeds": ns(10)}
    assert sum(out["idle_by_span"].values()) == ns(430)


def test_device_time_goes_to_the_span_that_launched_it():
    out = program_trace.join(DEVICE, RUNTIME, SPANS, WINDOW, launches=2)
    assert out["device_by_span"] == {
        "kernel.count": ns(50), "run_point.pull": ns(250),
        "run_point": ns(250), "unmatched": ns(20)}


def test_the_window_clips_activity_and_launches_outside_spans_count_so():
    device = [(TORCH, -50, 40, 1), (TORCH, 990, 1100, 2)]
    runtime = [("cudaLaunchKernel", -60, 1), ("cudaLaunchKernel", 950, 2)]
    out = program_trace.join(device, runtime, SPANS, WINDOW, launches=0)
    assert out["device_by_span"] == {"outside": ns(50)}
    assert sum(out["idle_by_span"].values()) == ns(950)


def test_the_three_launch_counts():
    out = program_trace.join(DEVICE, RUNTIME, SPANS, WINDOW, launches=2)
    # two records of the program's kernels; one runtime launch record made
    # inside a kernel span (the one at 650 lies in run_point's self time)
    assert (out["launches"], out["own_kernels"],
            out["runtime_launches"]) == (2, 2, 1)


class _Event:
    def __init__(self, name, start, dur, corr, device):
        self._v = (name, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def _tracer(shift, perf=0):
    """A traced session whose trace keeps the ``time`` clock, ``shift`` ns
    ahead of ``perf_counter``, with the marker kernel first."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Event("fill (marker)", perf + shift - 2000, 10, 99, cuda)]
    events += [_Event(n, a + shift, b - a, c, cuda) for n, a, b, c in DEVICE]
    events += [_Event(n, t + shift, 5, c, cpu) for n, t, c in RUNTIME]
    events += [_Event("Activity Buffer Request", shift, 5, 1, cpu)]
    kineto = types.SimpleNamespace(events=lambda: events)
    t = tracing.Trace.__new__(tracing.Trace)
    t.enabled, t.launches = True, 2
    t.prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto))
    t.marks = (perf - 3000, 7, perf + shift - 3000)
    return t


def _run(attempted=2, trace=True):
    return {"attempted": attempted, "window_ns": WINDOW,
            "trace": {"busy_s": 570e-9, "launches": 2} if trace else None,
            "spans": harness.Spans()}


@pytest.fixture
def recorder(monkeypatch):
    """A program whose recorder holds :data:`SPANS`."""
    mod = types.ModuleType("polar_tpu_torch.utils.profiling")
    mod.take_spans = lambda: (list(SPANS), 3)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def test_read_puts_the_trace_on_the_host_clock(recorder):
    shift = 1_700_000_000 * 10**9
    out = program_trace.read(_tracer(shift), WINDOW, 2)
    want = program_trace.join(DEVICE, RUNTIME, SPANS, WINDOW, launches=2)
    assert {k: out[k] for k in want} == want
    assert (out["spans"], out["dropped"], out["calls"]) == (5, 3, 2)


def _read(name, run):
    return harness.Bench({}).reader(name).read(run)


def test_the_readers_find_the_session_in_a_calling_frame(recorder):
    tracer = _tracer(5 * 10**9)  # noqa: F841  (found by program_trace.of)
    run = _run()
    assert _read("idle_in_loop_ms_per_call.campaign", run) == \
        pytest.approx((110 + 60 + 10 + 200) * 1e-6 / 2)
    assert _read("idle_in_launch_ms_per_call.campaign", run) == \
        pytest.approx(20 * 1e-6 / 2)
    assert _read("launches_per_call.campaign", run) == 1.0
    assert run["program"]["own_kernels"] == 2
    # the two campaign metrics and the idle outside every span make the
    # window's idle
    loop, launch = (_read(m, run) for m in (
        "idle_in_loop_ms_per_call.campaign",
        "idle_in_launch_ms_per_call.campaign"))
    outside = 1e3 * run["program"]["idle_by_span"]["outside"] / 2
    assert loop + launch + outside == pytest.approx(430e-6 / 2)


def test_entry_copy_share(monkeypatch):
    spans = [("decode", 0, 100, -1), ("decode.transpose_in", 0, 20, 0),
             ("kernel.scratch_decoder", 20, 60, 0),
             ("decode.transpose_out", 60, 100, 0)]
    device = [(TORCH, 100, 130, 1), (OWN, 130, 230, 2), (TORCH, 230, 260, 3)]
    runtime = [("cudaLaunchKernel", 10, 1), ("cudaLaunchKernel", 40, 2),
               ("cudaLaunchKernel", 70, 3)]
    run = {"attempted": 1, "trace": {"busy_s": 160e-9},
           "program": program_trace.join(device, runtime, spans, (0, 300),
                                         launches=1)}
    assert _read("entry_copy_pct.decode", run) == pytest.approx(
        100 * 60 / 160)


def test_a_program_without_a_recorder_gives_none(monkeypatch):
    mod = types.ModuleType("polar_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    tracer = _tracer(5 * 10**9)
    assert program_trace.read(tracer, WINDOW, 2) is None
    names = ("idle_in_loop_ms_per_call.campaign",
             "idle_in_launch_ms_per_call.campaign",
             "launches_per_call.campaign", "entry_copy_pct.decode")
    run = _run()
    assert [_read(n, run) for n in names] == [None] * 4
    assert run["program"] is None
    # an untraced run, and a run with no session to find
    assert [_read(n, _run(trace=False)) for n in names] == [None] * 4
    del tracer
    monkeypatch.delitem(sys.modules, mod.__name__)
    assert [_read(n, _run()) for n in names] == [None] * 4
