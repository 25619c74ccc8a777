"""select_cpu_ms (engine and memstore): the mean, per query, of the thread
CPU time in the program's `select-series` spans (their `cpu_us`), over the
queries select_ms averages: select_ms less the time the selecting thread
waited, for the interpreter lock above all; nothing where no span carries
`cpu_us`."""


def read(ctx):
    queries = [tr["spans"] for tr in ctx["traces"]
               if any(s["name"] == "query" for s in tr["spans"])]
    if not any("cpu_us" in s for spans in queries for s in spans):
        return None
    per_query = [sum(s.get("cpu_us", 0) for s in spans
                     if s["name"] == "select-series") / 1e3
                 for spans in queries]
    return sum(per_query) / len(per_query)
