"""counters_pct.nonsys: the device time of the draws path's five counters
in the traced window, as a share of the card's busy time (%): the work
launched inside the program's span ``step.count`` and inside the counter
kernel's span ``kernel.count_frames`` nested in it. The join gives each
device activity to the innermost span around its launch, so
``count_pct.nonsys`` (``step.count`` alone) misses a kernel launched
through a wrapper's own span. A program with neither span gives nothing."""

from program_trace import of

SPANS = ("step.count", "kernel.count_frames")


def read(run):
    program = of(run)
    if program is None or run["trace"]["busy_s"] <= 0:
        return None
    parts = [program["device_by_span"][k] for k in SPANS
             if k in program["device_by_span"]]
    if not parts:
        return None
    return 100.0 * sum(parts) / run["trace"]["busy_s"]
