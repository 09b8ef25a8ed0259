"""The readers of the draws path's counters in ``n16384.nonsys.campaign``:
``counters_pct.nonsys`` (the device time launched inside ``step.count``
and the counter kernel's span ``kernel.count_frames`` nested in it, over
busy time) and ``count_frames_roofline`` (the counter kernel against its
bound), on run records made by hand; the roofline's frozen work model
against the program's; neither imports JAX or the program."""

import subprocess
import sys

import pytest
from conftest import BENCH, REPO

import harness
from polar_tpu_torch.utils import cost

NEW_MODULES = ["metrics/counters_pct.nonsys.py",
               "metrics/count_frames_roofline.py"]
N, K, B = 16384, 8192, 4096


def _run(by_span, calls=2480, busy=8.589):
    return {"trace": {"busy_s": busy}, "attempted": calls, "n": N, "k": K,
            "frames": calls * B,
            "program": {"device_by_span": dict(by_span)}}


def test_the_counters_share_adds_the_nested_kernel_span():
    b = harness.Bench({})
    run = _run({"step.count": 0.2, "kernel.count_frames": 0.01,
                "kernel.interp_decoder": 1.5}, busy=2.0)
    assert b.reader("counters_pct.nonsys").read(run) == pytest.approx(10.5)
    # the torch counters (no kernel span) read as count_pct.nonsys reads
    parent = _run({"step.count": 3.070, "kernel.interp_decoder": 4.0},
                  busy=8.878)
    assert b.reader("counters_pct.nonsys").read(parent) == pytest.approx(
        b.reader("count_pct.nonsys").read(parent))
    # the kernel alone, as the draws step launches it
    kernel = _run({"kernel.count_frames": 0.181})
    assert b.reader("counters_pct.nonsys").read(kernel) == pytest.approx(
        100 * 0.181 / 8.589)
    assert b.reader("count_pct.nonsys").read(kernel) is None


@pytest.mark.parametrize("by_span", [{}, {"kernel.interp_decoder": 1.0}])
def test_the_counters_share_without_either_span_is_none(by_span):
    b = harness.Bench({})
    assert b.reader("counters_pct.nonsys").read(_run(by_span)) is None


def test_the_roofline_reads_the_kernel_span():
    roof = harness.Bench({}).reader("count_frames_roofline")
    run = _run({"kernel.count_frames": 0.181, "step.count": 0.5})
    least = 2 * (N + K) * run["frames"] / 3.35e12
    assert roof.read(run) == pytest.approx(100 * least / 0.181)
    assert 0 < roof.read(run) < 100
    # a program without the kernel's span, or without the recorder
    assert roof.read(_run({"step.count": 3.07})) is None
    run["program"] = None
    assert roof.read(run) is None
    assert harness.Bench({}).reader("counters_pct.nonsys").read(run) is None
    assert roof.read(dict(_run({"kernel.count_frames": 0.1}),
                          frames=0)) is None


@pytest.mark.parametrize("n,k,frames", [(16384, 8192, 4096),
                                        (1024, 512, 32768), (256, 77, 3)])
def test_the_roofline_model_is_the_programs(n, k, frames):
    roof = harness.Bench({}).reader("count_frames_roofline")
    assert roof.count_work(n, k, frames) == cost.count_frames_work(n, k,
                                                                    frames)


def test_the_new_readers_import_no_jax_and_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "for f in %r:\n"
        "    harness._load_module(harness.HERE / f)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m.startswith('polar')))\n"
    ) % (str(BENCH), str(REPO), NEW_MODULES)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
