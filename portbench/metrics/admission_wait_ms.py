"""admission_wait_ms (admission): the mean wait of the window's admitted
queries for an admission slot, from the deltas of the program's
`filodb_admission_wait_seconds` histogram: 1000 x sum / count; nothing
where no query was admitted through the gate (or the program keeps no
such histogram)."""


def read(ctx):
    c = ctx["counters"]
    n = c.get("filodb_admission_wait_seconds_count", 0.0)
    if n <= 0:
        return None
    return 1e3 * c.get("filodb_admission_wait_seconds_sum", 0.0) / n
