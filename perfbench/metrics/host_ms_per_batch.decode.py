"""host_ms_per_batch.decode: the host's time in a call of the decoder
entry, from the call until it returns (its launches, not the decode), the
mean over the window (ms): the benchmark's own host-clock span
"decode"."""


def read(run):
    spans = run["spans"].seconds("decode")
    return 1e3 * sum(spans) / len(spans) if spans else None
