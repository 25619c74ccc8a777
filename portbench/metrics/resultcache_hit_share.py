"""resultcache_hit_share (front end and results cache): the share of the
window's range queries answered wholly or partly from the results cache,
from the program's counters' deltas over the window."""

_OUTCOMES = ("filodb_result_cache_hits_total",
             "filodb_result_cache_partial_hits_total",
             "filodb_result_cache_misses_total",
             "filodb_result_cache_bypassed_total")


def read(ctx):
    c = ctx["counters"]
    queries = sum(c.get(k, 0.0) for k in _OUTCOMES)
    if queries <= 0:
        return None
    return 100.0 * (c.get(_OUTCOMES[0], 0.0) + c.get(_OUTCOMES[1], 0.0)) \
        / queries
