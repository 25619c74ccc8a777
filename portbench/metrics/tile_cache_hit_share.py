"""tile_cache_hit_share (tile store): the share of tile lookups that found
their device tiles built, from the program's counters' deltas over the
window: hits / (hits + builds)."""


def read(ctx):
    c = ctx["counters"]
    hits = c.get("filodb_tile_cache_hits_total", 0.0)
    builds = c.get("filodb_tile_builds_total", 0.0)
    if hits + builds <= 0:
        return None
    return 100.0 * hits / (hits + builds)
