"""select_memo_hit_share (engine and memstore): the share of selected
series whose partition's selection record was reused, from the program's
counters' deltas over the window: hits / (hits + misses). Nothing where
the program keeps no such counters."""


def read(ctx):
    c = ctx["counters"]
    hits = c.get("filodb_select_memo_hits_total", 0.0)
    misses = c.get("filodb_select_memo_misses_total", 0.0)
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
