"""entry_copy_pct.decode: the device time of the work launched inside the
frame-major decode entry's copies (the program's spans
``decode.transpose_in`` and ``decode.transpose_out``, joined to the
device activity through its launch's runtime record), as a share of the
card's busy time in the traced window (%)."""

from program_trace import of

COPIES = ("decode.transpose_in", "decode.transpose_out")


def read(run):
    program = of(run)
    if program is None or run["trace"]["busy_s"] <= 0:
        return None
    copies = sum(program["device_by_span"].get(k, 0.0) for k in COPIES)
    return 100.0 * copies / run["trace"]["busy_s"]
