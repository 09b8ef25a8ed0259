"""launches_per_call.campaign: the program's kernel launches in the traced
window, as its wrappers' ``launches`` and ``earlier_launches`` counters
count them (one a C entry's launch), over the calls."""

from program_trace import of


def read(run):
    if of(run) is None or not run["attempted"]:
        return None
    return run["trace"]["launches"] / run["attempted"]
