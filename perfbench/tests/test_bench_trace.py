"""The trace arithmetic: busy time, idle share, roofline, on synthetic
device activity, and a trace with nothing to read fails."""

import pytest

import harness
import tracing

OWN = "void (anonymous namespace)::interp_tile_kernel<true>(...)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, ...>(...)"


def _spans(items):
    s = harness.Spans()
    s.items.extend(items)
    return s


def test_union_merges_overlaps():
    covered, merged = tracing.union([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert covered == 35
    assert merged == [(0, 20), (30, 45)]


def test_summary_busy_idle_and_gaps():
    events = [(OWN, 100, 400), (TORCH, 350, 500), (OWN, 700, 900)]
    spans = [("run_point", -10, 600), ("step", 0, 300),
             ("run_point", 600, 1000)]
    out = tracing.summarize(events, (0, 1000), spans, launches=2)
    assert out["busy_s"] == pytest.approx(600e-9)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["own_kernels"] == 2
    # gaps: [0, 100) in step, [500, 700) in run_point, [900, 1000)
    assert out["idle_gaps"][0] == ["run_point", pytest.approx(200e-9)]
    assert sorted(g[1] for g in out["idle_gaps"]) == pytest.approx(
        [100e-9, 100e-9, 200e-9])
    assert out["idle_by_span"]["step"] == pytest.approx(100e-9)
    assert out["idle_by_span"]["run_point"] == pytest.approx(300e-9)
    assert out["device_ops"][0] == [OWN, pytest.approx(500e-9)]


def test_activity_outside_the_window_is_cut():
    events = [(OWN, -50, 50), (OWN, 950, 1200)]
    out = tracing.summarize(events, (0, 1000), [], launches=2)
    assert out["busy_s"] == pytest.approx(100e-9)


def test_empty_trace_fails():
    with pytest.raises(tracing.TraceError):
        tracing.summarize([], (0, 1000), [], launches=3)
    with pytest.raises(tracing.TraceError):
        tracing.summarize([(OWN, 2000, 3000)], (0, 1000), [], launches=3)


def test_trace_without_the_programs_kernels_fails():
    with pytest.raises(tracing.TraceError):
        tracing.summarize([(TORCH, 0, 500)], (0, 1000), [], launches=4)


def _reader(name):
    return harness.Bench({}).reader(name)


def test_idle_and_roofline_readers():
    trace = {"busy_s": 0.8, "window_s": 1.0}
    run = {"trace": trace, "n": 1024, "k": 512, "frames": 32768 * 100,
           "spans": _spans([("step", 0, 10**6), ("step", 0, 3 * 10**6)])}
    assert _reader("device_idle_pct.campaign").read(run) == pytest.approx(20)
    assert _reader("device_idle_pct.decode").read(run) == pytest.approx(20)
    # 94720 operations a frame at 67e12 operations/s over 0.8 s busy
    assert _reader("kernels_roofline.campaign").read(run) == pytest.approx(
        100 * 94720 * 32768 * 100 / 67e12 / 0.8)
    # (N + K) bytes a frame at 3.35e12 bytes/s
    assert _reader("kernels_roofline.decode").read(run) == pytest.approx(
        100 * 1536 * 32768 * 100 / 3.35e12 / 0.8)
    assert _reader("host_ms_per_call.campaign").read(run) == pytest.approx(2)
    assert _reader("host_ms_per_batch.decode").read(run) is None


def test_readers_find_nothing_without_a_trace():
    run = {"trace": None, "n": 1024, "k": 512, "frames": 10,
           "spans": _spans([])}
    for name in ("device_idle_pct.campaign", "kernels_roofline.campaign",
                 "kernels_roofline.decode", "host_ms_per_call.campaign"):
        assert _reader(name).read(run) is None
