"""count_pct.nonsys: the device time of the work launched inside the
program's span ``step.count`` (the five counters' torch reductions of the
draws path's step, in the u domain), as a share of the card's busy time in
the traced window (%). A program without that span gives nothing."""

from program_trace import of

COUNT = "step.count"


def read(run):
    program = of(run)
    if (program is None or run["trace"]["busy_s"] <= 0
            or COUNT not in program["device_by_span"]):
        return None
    return 100.0 * program["device_by_span"][COUNT] / run["trace"]["busy_s"]
