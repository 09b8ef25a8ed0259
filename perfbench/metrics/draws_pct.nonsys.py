"""draws_pct.nonsys: the device time of the work launched inside the draws
path's kernel wrappers (the program's spans ``kernel.channel_symbols``,
``kernel.block_encoder`` and ``kernel.channel_awgn``: the message, the
encode and the channel), joined to the device activity through its
launch's runtime record, as a share of the card's busy time in the traced
window (%)."""

from program_trace import of

DRAWS = ("kernel.channel_symbols", "kernel.block_encoder",
         "kernel.channel_awgn")


def read(run):
    program = of(run)
    if program is None or run["trace"]["busy_s"] <= 0:
        return None
    draws = [program["device_by_span"][k] for k in DRAWS
             if k in program["device_by_span"]]
    if not draws:
        return None
    return 100.0 * sum(draws) / run["trace"]["busy_s"]
