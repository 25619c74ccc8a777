"""select_ms (engine and memstore): the mean, per query, of the time in the
program's `select-series` spans (the series selection and decode)."""


def read(ctx):
    per_query = []
    for tr in ctx["traces"]:
        if any(s["name"] == "query" for s in tr["spans"]):
            per_query.append(sum(s["dur_us"] for s in tr["spans"]
                                 if s["name"] == "select-series") / 1e3)
    return sum(per_query) / len(per_query) if per_query else None
