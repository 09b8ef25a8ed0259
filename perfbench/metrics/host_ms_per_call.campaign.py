"""host_ms_per_call.campaign: the host's time in a step call of the
campaign, from the call until it returns (the launches, before
``run_point`` pulls the counters), the mean over the window (ms): the
benchmark's own host-clock span "step"."""


def read(run):
    spans = run["spans"].seconds("step")
    return 1e3 * sum(spans) / len(spans) if spans else None
