"""idle_in_launch_ms_per_call.campaign: the card's idle time in the traced
window while the host was inside a kernel wrapper's span
(``kernel.<key>``: from the wrapper's entry to its C call's return), over
the calls (ms a call)."""

from program_trace import KERNEL, per_call_ms


def read(run):
    return per_call_ms(run, lambda name: name.startswith(KERNEL))
