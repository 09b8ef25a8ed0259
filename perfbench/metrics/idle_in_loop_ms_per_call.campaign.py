"""idle_in_loop_ms_per_call.campaign: the card's idle time in the traced
window while the host was in one of the program's own spans other than a
kernel wrapper's, by self time, over the calls (ms a call). In the
campaign cells those spans are ``run_point`` (the tally and the loop
test), ``run_point.step`` (the step's Python between its kernel
wrappers), ``run_point.pull`` (the counters' pull: the host's wait and
wake-up), ``step.seeds`` (the Philox key draw) and ``step.unpack`` (the
counters' views); the split is in the run's ``program: ...`` line."""

from program_trace import KERNEL, OUTSIDE, per_call_ms


def read(run):
    return per_call_ms(run, lambda name: name != OUTSIDE
                       and not name.startswith(KERNEL))
