"""device_idle_pct.campaign: the share of the traced window in which nothing
ran on the card (%), from the profiler's device activity (kernels, copies,
fills) merged into busy intervals."""


def read(run):
    trace = run["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
