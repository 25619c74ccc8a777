"""dispatch_ms (backend dispatch): the mean, per query that opened one, of
the time in the program's `device-dispatch` spans; nothing where no query
of the window dispatched through the backend."""


def read(ctx):
    per_query = []
    for tr in ctx["traces"]:
        d = [s["dur_us"] for s in tr["spans"] if s["name"] == "device-dispatch"]
        if d:
            per_query.append(sum(d) / 1e3)
    return sum(per_query) / len(per_query) if per_query else None
