"""encode_ms (HTTP edge and JSON): the mean, per query, of the stretch of
the program's `query` span after its `execute` span ends: the answer's
statistics and its JSON encode (the encode fast path opens no span of its
own)."""


def read(ctx):
    tails = []
    for tr in ctx["traces"]:
        q = [s for s in tr["spans"] if s["name"] == "query"]
        ex = [s for s in tr["spans"] if s["name"] == "execute"]
        if len(q) == 1 and ex:
            end_q = q[0]["start_us"] + q[0]["dur_us"]
            end_x = max(s["start_us"] + s["dur_us"] for s in ex)
            tails.append((end_q - end_x) / 1e3)
    return sum(tails) / len(tails) if tails else None
