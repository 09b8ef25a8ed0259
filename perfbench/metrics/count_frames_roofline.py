"""count_frames_roofline: the draws path's counter kernel against its
bound in the traced window (%): the least time of the work the counters
must do for the frames the window completed, over the device time
launched inside the program's span ``kernel.count_frames``. A program
without that span gives nothing.

The work model is the least such a count must do, counted from the code's
shape and the frames done: per frame the int8 message and decoded bits (K
bytes each) and codeword and LLRs (N bytes each) read once, two compares
an LLR (zero, its sign against the codeword's) and three an estimate
(zero, its sign against the message's, the frame's any). (A frozen copy,
as this metric was defined.)"""

from peaks import least_seconds
from program_trace import of

SPAN = "kernel.count_frames"


def count_work(n: int, k: int, frames: int) -> tuple[int, int]:
    """(bytes, operations) of counting ``frames`` frames at Polar(n, k)."""
    return 2 * (n + k) * frames, (2 * n + 3 * k) * frames


def read(run):
    program = of(run)
    if program is None or not run["frames"]:
        return None
    seconds = program["device_by_span"].get(SPAN)
    if not seconds:
        return None
    least, _ = least_seconds(*count_work(run["n"], run["k"], run["frames"]))
    return 100.0 * least / seconds
