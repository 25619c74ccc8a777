"""Incremental range-query results cache: step-aligned extent reuse,
ingest-watermark invalidation, tail-only recomputation.

Dashboard traffic is dominated by the SAME PromQL range query re-issued
every few seconds with a sliding time window; the plan cache
already skips re-parsing, but the computed per-step matrix was thrown
away and every refresh re-ran select -> decode -> device eval -> pack ->
encode over the whole range. This module is the Cortex/Thanos/Mimir
"query frontend" split-and-cache design folded into the serving node:

* Entries are **per-step matrix extents** — ``[num_series, num_steps]``
  float64 columns plus per-series label keys — stored in a
  byte-accounted LRU keyed on the plan cache's range-abstracted key
  ``(dataset, query text, step)`` plus **step alignment**
  (``start % step``): a request whose grid phase differs cannot reuse
  cached columns.

* On a hit, the requested ``[start, end]`` splits into the cached
  extent and (at most) a head + tail of uncovered steps; only those
  spans run through the normal pipeline (plan rebase -> batcher ->
  device), and :func:`filodb_tpu_torch.query.engine.assemble_stitched` builds
  the response grid from cached columns + fresh span columns. Step
  values are per-step functions of the samples (windows anchor on the
  step, not the grid bounds), so stitched responses are byte-identical
  to a fresh full-range compute.

* **Freshness horizon**: steps newer than the shards' min ingest
  watermark (itself the MIN over per-partition last timestamps — the
  per-partition OOO guard means no known series can ever ingest
  at/below it) — or within ``hot_window_ms`` of the wall clock — are
  never served from (or admitted to) the cache; they may still receive
  samples. A watermark **regression** (stream replay, shard adoption/
  recovery — including a watermark appearing where an extent saw none)
  invalidates the overlapping extent, and a shard **backfill epoch**
  bump (a new/re-created series whose first rows land at/below the
  watermark, dirtying already-settled steps without moving the min)
  invalidates on lookup: the replayed/backfilled world may differ from
  the one the extent was computed against.

* **Dispatch scope is part of the key**: a ``dispatch=local`` /
  gRPC ``local_only`` evaluation (the pushdown loop-prevention hop)
  sees only this node's shards — its extents and a full fan-out
  query's extents live under distinct keys and never serve each other.

* **Series churn**: a computed span containing a series the cached
  extent has never seen cannot be stitched (its cached-step columns are
  unknown, and for aggregates its backfill could dirty neighbouring
  columns too) — the session computes-through with a full fresh
  evaluation and re-seeds the extent.

* **Degraded results are never admitted** (the partial-results guard):
  any ``partial`` flag or warning on the result or the engine's
  QueryStats skips the store, so a chaos-injected partial response can
  never poison later healthy queries.

Topology/schema invalidation rides the plan cache's listener hook
(:meth:`filodb_tpu_torch.query.plancache.PlanCache.add_invalidation_listener`)
— any world change that clears cached plans clears cached results.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.lint.caches import cache_registry, event_source
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query.model import GridResult
from filodb_tpu_torch.query.plancache import range_abstracted_key

_CACHED_STEPS_HELP = ("Steps served from the results cache per hit "
                      "(full or partial)")
# per-series bookkeeping overhead charged against the byte budget on
# top of the value matrix (label dicts, key tuples, list slots)
_KEY_OVERHEAD = 128


def result_cacheable(plan) -> bool:
    """Plans whose extents may be cached: the plan cache's rebasable
    closure (lp_replace_range-rewritable, carries an evaluation grid)
    MINUS order-dependent nodes — ``sort()``/``sort_desc()`` order
    series by the range's LAST step and ``limit()`` truncates by
    position, so their output depends on the grid bounds rather than
    per-step data and extents must not be reused across ranges."""
    from filodb_tpu_torch.query import logical as lp
    from filodb_tpu_torch.query.plancache import _cacheable
    from filodb_tpu_torch.query.planner import walk_plan_tree
    if not _cacheable(plan):
        return False
    found = [False]

    def visit(p):
        if isinstance(p, (lp.ApplySortFunction, lp.ApplyLimitFunction)):
            found[0] = True
            return True
        return False

    walk_plan_tree(plan, visit)
    return not found[0]


@event_source("dispatch-scope")
def dispatch_scope(engine) -> bool:
    """The engine's dispatch scope as a cache-key component: a
    ``dispatch=local`` / gRPC ``local_only`` evaluation (the pushdown
    loop-prevention hop) sees only this node's shards, so its extents
    and a full fan-out query's extents must never serve each other."""
    return bool(getattr(engine, "local_dispatch", False))


@event_source("watermark")
def shards_watermark(shards: Sequence[object]) -> Optional[int]:
    """Freshness input: min ingest watermark over the engine's local
    shards that HAVE ingested, or None when none exposes one (pure
    remote dispatch / all-empty — only the hot window bounds staleness
    then, the Cortex frontend's max-freshness trade). Each shard's
    watermark is itself the min over its per-partition last timestamps
    (memstore), so no already-known series anywhere can ingest at or
    below the result; backfill by NEW series rides the shard's
    ingest_backfill_epoch instead (see :func:`shards_epoch`).
    Never-ingested shards (-1) constrain nothing; the moment one starts
    ingesting, the per-extent REGRESSION check (which also fires when a
    watermark appears where the extent recorded none) drops overlapping
    extents — so late backfill into a previously empty shard
    invalidates instead of serving stale. Remote shards behind a
    fan-out planner contribute when the planner stamped their group
    with a GOSSIPED watermark (the health-body watermark exchange,
    parallel/cluster.py peer_state_sink -> planner._stamp_peer_
    freshness) — fan-out extents then carry the same settled-time
    bound local ones do; unstamped groups stay invisible and only the
    hot window bounds their staleness, with the dispatch-scope key
    component fencing their scope."""
    wms = [getattr(s, "ingest_watermark_ms", None) for s in shards]
    wms = [w for w in wms if w is not None and w >= 0]
    if not wms:
        return None
    return int(min(wms))


@event_source("watermark")
def watermark_coverage(shards: Sequence[object]) -> int:
    """How many shards in the scope CONTRIBUTE a watermark (have
    ingested). Cached alongside the extent and checked on lookup: a
    never-ingested shard that starts ingesting can enter the min-set
    at exactly the old minimum — the min itself then never moves and
    the per-shard backfill epoch never bumps (an empty shard's first
    series has no watermark to land below), yet the extent's steps now
    miss that shard's series. A coverage CHANGE is that event made
    visible, generalizing the single-shard "watermark appearing"
    regression to mixed scopes (and, via the gossip-stamped
    ``ingest_watermark_coverage`` on remote groups, to fan-out
    scopes)."""
    total = 0
    for s in shards:
        cov = getattr(s, "ingest_watermark_coverage", None)
        if cov is not None:
            total += int(cov)
            continue
        wm = getattr(s, "ingest_watermark_ms", None)
        if wm is not None and wm >= 0:
            total += 1
    return total


@event_source("backfill-epoch")
def shards_epoch(shards: Sequence[object]) -> int:
    """Sum of the local shards' backfill epochs. A per-partition OOO
    guard cannot stop a NEW (or re-created/evicted-then-dropped) series
    from ingesting below the shard watermark; the shard bumps its
    epoch on any such entrance, and extents recorded under a different
    epoch are dropped on lookup (the backfilled steps were cached as
    settled). Monotone under bumps; a changed sum of any kind (shard
    replacement resets to 0) reads as invalidation."""
    return sum(int(getattr(s, "ingest_backfill_epoch", 0) or 0)
               for s in shards)


@event_source("integrity-quarantine")
def shards_quarantine(shards: Sequence[object]) -> int:
    """Unresolved quarantined-record count over the engine's local
    shards (the storage-integrity rail). A shard whose durable files
    quarantined records may be missing arbitrary samples — results
    computed over it are not wrong (the live memstore is intact) but
    extents CACHED from it could outlive a later repair/replay that
    restores the quarantined data, serving the lossy view long after
    the store healed. Any nonzero count makes the scope uncacheable
    and refuses existing extents until the quarantine is resolved
    (fsck repair + restart resets the count)."""
    return sum(int(getattr(s, "integrity_quarantined_records", 0) or 0)
               for s in shards)


def _pow2_spans(spans: List[Tuple[int, int]], start_ms: int,
                step_ms: int, grid_end: int) -> List[Tuple[int, int]]:
    """Widen uncovered spans to power-of-two step counts by extending
    them INTO covered territory (head spans grow toward the end, tail
    spans toward the start, both clamped to the request grid).

    Why: the device executors specialize on the step count — a sliding
    window whose raw tail length changes by one step per refresh would
    recompile the kernel on EVERY request (a ~100ms+ stall that dwarfs
    the cached win). Bucketed spans keep the shape set tiny (1, 2, 4,
    ... steps -> one compile each, then cache hits forever). The extra
    steps recompute values the extent already holds — bit-identical, so
    the stitch is unaffected; only the cached/computed step accounting
    reflects the overlap honestly."""
    out: List[Tuple[int, int]] = []
    for lo, hi in spans:
        n = (hi - lo) // step_ms + 1
        nb = 1
        while nb < n:
            nb <<= 1
        if lo == start_ms:              # head: extend toward the end
            out.append((lo, min(grid_end, lo + (nb - 1) * step_ms)))
        else:                           # tail: extend toward the start
            out.append((max(start_ms, hi - (nb - 1) * step_ms), hi))
    if len(out) == 2 and out[0][1] + step_ms >= out[1][0]:
        return [(start_ms, grid_end)]   # widened spans met: one pass
    return out


class CachedExtent:
    """One contiguous step-aligned extent of cached matrix columns.
    Immutable after construction (value array is frozen); lookups hand
    out column views, never copies of the whole matrix."""

    __slots__ = ("start_ms", "end_ms", "step_ms", "keys", "values",
                 "watermark_ms", "epoch", "coverage", "nbytes",
                 "encode_memo")

    def __init__(self, start_ms: int, end_ms: int, step_ms: int,
                 keys: List[Dict[str, str]], values: np.ndarray,
                 watermark_ms: Optional[int], epoch: int = 0,
                 coverage: int = 0):
        self.start_ms = int(start_ms)
        self.end_ms = int(end_ms)
        self.step_ms = int(step_ms)
        self.keys = keys
        values.setflags(write=False)
        self.values = values
        self.watermark_ms = watermark_ms
        self.epoch = int(epoch)     # shards' backfill-epoch sum at build
        self.coverage = int(coverage)   # shards contributing a watermark
        self.nbytes = int(values.nbytes) + _KEY_OVERHEAD * len(keys) + 256
        # (start_ms, end_ms) -> rendered JSON result rows: repeat FULL
        # hits splice pre-encoded bytes (prom_json.matrix_bytes
        # rows_memo). Dies with the extent, so it can never outlive the
        # values it renders; one rendered range at a time, and its text
        # bytes are CHARGED against the LRU budget via
        # ResultCache._memo_charge (rendered rows run ~3x the matrix).
        self.encode_memo: Dict[Tuple[int, int], str] = {}

    @property
    def steps(self) -> np.ndarray:
        return np.arange(self.start_ms, self.end_ms + 1, self.step_ms,
                         dtype=np.int64)


class _EncodeMemo:
    """Handle prom_json.matrix_bytes uses to reuse/store rendered row
    text for one (extent, range). Reads are lock-free (a racing clear
    just misses); stores go through the cache so the text bytes ride
    the byte budget."""

    __slots__ = ("cache", "cache_key", "ext", "range_key")

    def __init__(self, cache: "ResultCache", cache_key, ext, range_key):
        self.cache = cache
        self.cache_key = cache_key
        self.ext = ext
        self.range_key = range_key

    def get(self) -> Optional[str]:
        return self.ext.encode_memo.get(self.range_key)

    def put(self, text: str) -> None:
        self.cache._memo_charge(self.cache_key, self.ext,
                                self.range_key, text)


class RangeSession:
    """One range query's passage through the results cache.

    ``begin`` decides what must actually execute (``plans``: zero, one
    or two rebased sub-plans — or the full plan on a miss/bypass); the
    caller materializes + executes them through the normal pipeline and
    hands the grids to :meth:`finish`, which stitches, applies the
    degraded-result admission guard, rolls the extent forward, and
    returns the response result. ``state`` after finish is the
    disposition surfaced in response timings and span tags: off /
    bypass / uncacheable / miss / partial / hit / churn."""

    __slots__ = ("cache", "state", "plans", "key", "dataset", "query",
                 "start_ms", "step_ms", "end_ms", "full_plan",
                 "cached_steps", "computed_steps", "horizon_ms",
                 "watermark_ms", "epoch", "coverage", "_extent",
                 "_cov")

    def __init__(self, cache: "ResultCache", state: str, plans: List,
                 full_plan, key, dataset: str, query: str,
                 start_ms: int, step_ms: int, end_ms: int,
                 horizon_ms: int = -1,
                 watermark_ms: Optional[int] = None,
                 epoch: int = 0,
                 coverage: int = 0,
                 extent: Optional[CachedExtent] = None,
                 cov: Optional[Tuple[int, int]] = None,
                 cached_steps: int = 0, computed_steps: int = 0):
        self.cache = cache
        self.state = state
        self.plans = plans
        self.full_plan = full_plan
        self.key = key
        self.dataset = dataset
        self.query = query
        self.start_ms = start_ms
        self.step_ms = step_ms
        self.end_ms = end_ms
        self.horizon_ms = horizon_ms
        self.watermark_ms = watermark_ms
        self.epoch = epoch
        self.coverage = coverage
        self._extent = extent
        self._cov = cov
        self.cached_steps = cached_steps
        self.computed_steps = computed_steps

    def encode_memo(self):
        """Row-text memo handle for prom_json.matrix_bytes on a FULL
        hit — the rendered rows are a pure function of the immutable
        extent and the range — else None."""
        if self.state != "hit" or self._extent is None:
            return None
        return _EncodeMemo(self.cache, self.key, self._extent,
                           (self.start_ms, self.end_ms))

    # -- result assembly --------------------------------------------------
    def finish(self, engine, grids: Sequence) -> object:
        """Stitch/store and return the response result. ``grids`` holds
        the executed results of ``plans`` in order."""
        if self.state in ("off", "bypass", "uncacheable"):
            return grids[0] if grids else None
        if self.state == "miss":
            res = grids[0] if grids else None
            self.cache._record_miss(self.computed_steps)
            self._maybe_store(engine, res)
            return res
        # hit / partial: assemble from the extent + computed spans
        from filodb_tpu_torch.query.engine import assemble_stitched
        ext = self._extent
        lo, hi = self._cov
        i0 = (lo - ext.start_ms) // ext.step_ms
        i1 = (hi - ext.start_ms) // ext.step_ms + 1
        steps = np.arange(self.start_ms, self.end_ms + 1, self.step_ms,
                          dtype=np.int64)
        if self.state == "hit":
            # full hit: the extent covers every requested step — serve
            # VIEWS straight off the frozen extent (no matrix copy, no
            # key rebuild) and skip the store (nothing to roll forward)
            grid = GridResult(steps, ext.keys, ext.values[:, i0:i1])
            self.cache._record_hit(full=True,
                                   cached_steps=self.cached_steps,
                                   computed_steps=0)
            obs_metrics.observe("filodb_resultcache_cached_steps",
                                _CACHED_STEPS_HELP,
                                float(self.cached_steps),
                                buckets=obs_metrics.STEPS_BUCKETS)
            return grid
        with obs_trace.span("resultcache-stitch", state=self.state,
                            cached_steps=self.cached_steps,
                            spans=len(grids)):
            grid, churn = assemble_stitched(
                steps, ext.steps[i0:i1], ext.keys,
                ext.values[:, i0:i1], grids)
        if churn:
            # compute-through: series the extent has never seen cannot
            # be stitched — evaluate the whole range fresh and re-seed
            self.state = "churn"
            self.computed_steps += self.cached_steps
            self.cached_steps = 0
            self.cache._record_churn(self.computed_steps)
            ex = engine.materialize(self.full_plan)
            res = ex.execute()
            self._maybe_store(engine, res)
            return res
        self.cache._record_hit(full=False,
                               cached_steps=self.cached_steps,
                               computed_steps=self.computed_steps)
        obs_metrics.observe("filodb_resultcache_cached_steps",
                            _CACHED_STEPS_HELP, float(self.cached_steps),
                            buckets=obs_metrics.STEPS_BUCKETS)
        self._maybe_store(engine, grid)
        return grid

    def _maybe_store(self, engine, res) -> None:
        """Admission guard + store: only clean (non-partial, warning-
        free, non-histogram) grid results enter the cache, trimmed to
        the freshness horizon."""
        if not isinstance(res, GridResult) or res.is_hist():
            return
        st = getattr(engine, "stats", None)
        degraded = (res.partial or bool(res.warnings)
                    or bool(getattr(st, "partial", False))
                    or bool(getattr(st, "warnings", ())))
        if degraded:
            self.cache._record_degraded_skip()
            return
        self.cache._store(self.key, res, self.start_ms, self.step_ms,
                          self.end_ms, self.horizon_ms,
                          self.watermark_ms, self.epoch, self.coverage)


# topology/schema events PUSH through the plan-cache listener chain to
# `invalidate`; watermark, backfill-epoch, dispatch-scope, and
# integrity-quarantine are PULL events — both serving entry points
# must keep reading their @event_source functions (shards_watermark/
# watermark_coverage, shards_epoch, dispatch_scope, shards_quarantine).
@cache_registry("results",
                invalidated_by={"topology-epoch": "invalidate",
                                "schema": "invalidate"},
                validated_by={"watermark": ("begin", "stale_serve"),
                              "backfill-epoch": ("begin",
                                                 "stale_serve"),
                              "dispatch-scope": ("begin",
                                                 "stale_serve"),
                              "integrity-quarantine": ("begin",
                                                       "stale_serve")},
                keyed=("dataset", "query-text", "step", "grid-phase",
                       "dispatch-scope"))
class ResultCache:
    """Byte-accounted LRU of :class:`CachedExtent`, keyed
    ``(dataset, query, step, start % step, local_dispatch)``.

    Concurrency: HTTP handler threads look up and store concurrently
    while topology/schema events and watermark regressions invalidate;
    every access to the entry map and counters rides ``_lock``. Span
    evaluation happens strictly OUTSIDE the lock — lookups return
    immutable extent snapshots (frozen arrays), so a concurrent
    invalidation never mutates a grid mid-stitch."""

    def __init__(self, max_bytes: int = 64 << 20,
                 hot_window_ms: float = 10_000.0,
                 clock=time.time):
        self.max_bytes = int(max_bytes)
        self.hot_window_ms = float(hot_window_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, CachedExtent]" = OrderedDict()
        self._bytes = 0
        self.hits = 0               # every requested step from cache
        self.partial_hits = 0       # stitched: cached extent + spans
        self.misses = 0
        self.stitches = 0           # span evaluations stitched in
        self.churn_recomputes = 0   # compute-through on series churn
        self.bypassed = 0           # &cache=false
        self.uncacheable = 0
        self.stores = 0
        self.evictions = 0
        self.degraded_skips = 0     # partial/warning results refused
        self.invalidations = 0
        self.watermark_invalidations = 0
        self.backfill_invalidations = 0     # epoch-change drops
        self.integrity_refused = 0  # scope has unresolved quarantine
        self.cached_steps_served = 0
        self.computed_steps_served = 0
        self.stale_serves = 0       # brownout rung: served past horizon

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    # -- the serving entry points ----------------------------------------
    def begin(self, engine, dataset: str, query: str, plan,
              start_ms: int, step_ms: int, end_ms: int,
              bypass: bool = False) -> RangeSession:
        """Split one range request against the cache. Returns a session
        whose ``plans`` the caller must materialize + execute through
        the normal pipeline, then hand to ``session.finish``."""
        mk = RangeSession
        if not self.enabled:
            return mk(self, "off", [plan], plan, None, dataset, query,
                      start_ms, step_ms, end_ms)
        if bypass:
            with self._lock:
                self.bypassed += 1
            return mk(self, "bypass", [plan], plan, None, dataset,
                      query, start_ms, step_ms, end_ms)
        if step_ms <= 0 or not result_cacheable(plan):
            with self._lock:
                self.uncacheable += 1
            return mk(self, "uncacheable", [plan], plan, None, dataset,
                      query, start_ms, step_ms, end_ms)
        shards = getattr(engine, "shards", ())
        if shards_quarantine(shards) > 0:
            # unresolved quarantine in scope: the durable tier is
            # missing records — neither serve nor store extents from
            # this world (the query still runs, uncached)
            with self._lock:
                self.integrity_refused += 1
                self.uncacheable += 1
            return mk(self, "uncacheable", [plan], plan, None, dataset,
                      query, start_ms, step_ms, end_ms)
        wm = shards_watermark(shards)
        ep = shards_epoch(shards)
        cov_n = watermark_coverage(shards)
        now_ms = int(self._clock() * 1000)
        horizon = now_ms - int(self.hot_window_ms)
        if wm is not None:
            horizon = min(horizon, wm)
        # dispatch scope rides the key: a local-only hop (pushdown loop
        # prevention) evaluates a subset of the fan-out world — the two
        # must never share extents
        key = range_abstracted_key(dataset, query, step_ms) \
            + (int(start_ms) % int(step_ms), dispatch_scope(engine))
        n_steps = (end_ms - start_ms) // step_ms + 1
        # the grid's LAST step — coverage and span math run on the step
        # grid, not the raw end (which need not be step-aligned)
        grid_end = start_ms + (n_steps - 1) * step_ms
        ext = self._lookup(key, wm, ep, cov_n)
        # floor the horizon onto this request's step grid
        hz_hi = start_ms + ((horizon - start_ms) // step_ms) * step_ms \
            if horizon >= start_ms else start_ms - step_ms
        cov = None
        if ext is not None:
            lo = max(start_ms, ext.start_ms)
            hi = min(grid_end, ext.end_ms, hz_hi)
            if lo <= hi:
                cov = (lo, hi)
        if cov is None:
            return mk(self, "miss", [plan], plan, key, dataset, query,
                      start_ms, step_ms, end_ms, horizon_ms=horizon,
                      watermark_ms=wm, epoch=ep, coverage=cov_n,
                      computed_steps=n_steps)
        from filodb_tpu_torch.query.engine import (lp_replace_range,
                                             uncovered_spans)
        spans = _pow2_spans(
            uncovered_spans(start_ms, step_ms, grid_end, cov[0],
                            cov[1]),
            start_ms, step_ms, grid_end)
        sub_plans = [lp_replace_range(plan, lo, step_ms, hi)
                     for lo, hi in spans]
        computed = sum((hi - lo) // step_ms + 1 for lo, hi in spans)
        return mk(self, "hit" if not spans else "partial", sub_plans,
                  plan, key, dataset, query, start_ms, step_ms, end_ms,
                  horizon_ms=horizon, watermark_ms=wm, epoch=ep,
                  coverage=cov_n, extent=ext, cov=cov,
                  cached_steps=n_steps - computed,
                  computed_steps=computed)

    def stale_serve(self, engine, dataset: str, query: str, plan,
                    start_ms: int, step_ms: int, end_ms: int):
        """Brownout rung (tenant QoS, query/qos.py): serve whatever
        overlapping extent exists, PAST the freshness horizon — the
        caller has decided a stale answer beats shedding the query.

        Unlike :meth:`begin`, the hot window and watermark horizon are
        ignored (stale is the point), but the correctness invalidators
        still apply: a watermark REGRESSION, backfill-epoch change, or
        coverage change means the extent may describe a world that
        never existed — stale must never mean WRONG, so those extents
        are dropped here exactly as on the normal path. The extent must
        cover the request's first step (a head-missing stitch has no
        cheap assembly); a short tail truncates and the caller stamps
        the result partial. Returns a GridResult (``partial`` set on
        truncation) or None; the result is never re-admitted — the
        caller's shed warning trips the degraded-admission guard."""
        if not self.enabled or step_ms <= 0 \
                or not result_cacheable(plan):
            return None
        shards = getattr(engine, "shards", ())
        if shards_quarantine(shards) > 0:
            # stale must never mean LOSSY: a quarantined scope refuses
            # its extents even on the brownout rung
            with self._lock:
                self.integrity_refused += 1
            return None
        key = range_abstracted_key(dataset, query, step_ms) \
            + (int(start_ms) % int(step_ms), dispatch_scope(engine))
        ext = self._lookup(key, shards_watermark(shards),
                           shards_epoch(shards),
                           watermark_coverage(shards))
        if ext is None:
            return None
        n_steps = (end_ms - start_ms) // step_ms + 1
        grid_end = start_ms + (n_steps - 1) * step_ms
        if ext.start_ms > start_ms or ext.end_ms < start_ms:
            return None
        hi = min(grid_end, ext.end_ms)
        i0 = (start_ms - ext.start_ms) // ext.step_ms
        i1 = (hi - ext.start_ms) // ext.step_ms + 1
        steps = np.arange(start_ms, hi + 1, step_ms, dtype=np.int64)
        grid = GridResult(steps, ext.keys, ext.values[:, i0:i1])
        grid.partial = hi < grid_end
        with self._lock:
            self.stale_serves += 1
        return grid

    def execute(self, engine, dataset: str, query: str, plan,
                start_ms: int, step_ms: int, end_ms: int,
                bypass: bool = False):
        """Convenience wrapper (the gRPC Exec path): begin -> run the
        sub-plans through engine.materialize -> finish. Returns
        (result, session)."""
        ses = self.begin(engine, dataset, query, plan, start_ms,
                         step_ms, end_ms, bypass=bypass)
        grids = [engine.materialize(p).execute() for p in ses.plans]
        return ses.finish(engine, grids), ses

    # -- internals --------------------------------------------------------
    def _lookup(self, key, wm: Optional[int], epoch: int,
                coverage: int = 0) -> Optional[CachedExtent]:
        with self._lock:
            ext = self._entries.get(key)
            if ext is None:
                return None
            if coverage != ext.coverage:
                # a shard entered (or left) the watermark min-set: a
                # previously-empty shard's first series can land at
                # exactly the old minimum — min and epochs unmoved —
                # yet dirty every cached step (the mixed-scope
                # generalization of "watermark appearing")
                self._bytes -= ext.nbytes
                del self._entries[key]
                self.watermark_invalidations += 1
                return None
            if wm is not None and (ext.watermark_ms is None
                                   or wm < ext.watermark_ms):
                # watermark regression: the stream replayed / the shard
                # was re-adopted below the extent's build point — the
                # overlapping extent may describe a world that no
                # longer exists. A watermark APPEARING where the extent
                # recorded none is the same event: the empty world the
                # extent was computed against has since ingested
                # (possibly backfill below every cached step)
                self._bytes -= ext.nbytes
                del self._entries[key]
                self.watermark_invalidations += 1
                return None
            if epoch != ext.epoch:
                # a series entered a shard below its watermark since
                # this extent was built: steps the extent holds as
                # settled may now have samples the cached columns miss
                self._bytes -= ext.nbytes
                del self._entries[key]
                self.backfill_invalidations += 1
                return None
            self._entries.move_to_end(key)
            return ext

    def _store(self, key, grid: GridResult, start_ms: int, step_ms: int,
               end_ms: int, horizon_ms: int,
               watermark_ms: Optional[int], epoch: int = 0,
               coverage: int = 0) -> None:
        if key is None:
            return
        steps = grid.steps
        if steps.size == 0:
            return
        hi = int(np.searchsorted(steps, horizon_ms, side="right"))
        if hi <= 0:
            return              # everything is hotter than the horizon
        values = np.array(grid.values[:, :hi])      # own the memory
        ext = CachedExtent(int(steps[0]), int(steps[hi - 1]), step_ms,
                           [dict(k) for k in grid.keys], values,
                           watermark_ms, epoch, coverage)
        if ext.nbytes > self.max_bytes:
            return              # larger than the whole budget
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = ext
            self._bytes += ext.nbytes
            self.stores += 1
            while self._bytes > self.max_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1

    def _memo_charge(self, key, ext: CachedExtent, range_key,
                     text: str) -> None:
        """Admit rendered row text into an extent's encode memo,
        charging its bytes against the budget (one rendered range per
        extent — a new range replaces and refunds the old)."""
        with self._lock:
            if self._entries.get(key) is not ext:
                return          # extent replaced/evicted meanwhile
            if range_key in ext.encode_memo:
                return
            freed = sum(len(t) for t in ext.encode_memo.values())
            ext.encode_memo.clear()
            ext.encode_memo[range_key] = text
            delta = len(text) - freed
            ext.nbytes += delta
            self._bytes += delta
            while self._bytes > self.max_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1

    # -- bookkeeping (called by sessions) ---------------------------------
    def _record_hit(self, full: bool, cached_steps: int,
                    computed_steps: int) -> None:
        with self._lock:
            if full:
                self.hits += 1
            else:
                self.partial_hits += 1
                self.stitches += 1
            self.cached_steps_served += cached_steps
            self.computed_steps_served += computed_steps

    def _record_miss(self, computed_steps: int) -> None:
        with self._lock:
            self.misses += 1
            self.computed_steps_served += computed_steps

    def _record_churn(self, computed_steps: int) -> None:
        with self._lock:
            self.churn_recomputes += 1
            self.computed_steps_served += computed_steps

    def _record_degraded_skip(self) -> None:
        with self._lock:
            self.degraded_skips += 1

    # -- invalidation / introspection -------------------------------------
    def invalidate(self, reason: str = "") -> None:
        """Drop every extent (topology/schema change — wired to the
        plan cache's invalidation listener)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self.invalidations += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries), "bytes": self._bytes,
                "hits": self.hits, "partial_hits": self.partial_hits,
                "misses": self.misses, "stitches": self.stitches,
                "churn_recomputes": self.churn_recomputes,
                "bypassed": self.bypassed,
                "uncacheable": self.uncacheable,
                "stores": self.stores, "evictions": self.evictions,
                "degraded_skips": self.degraded_skips,
                "invalidations": self.invalidations,
                "watermark_invalidations":
                    self.watermark_invalidations,
                "backfill_invalidations":
                    self.backfill_invalidations,
                "cached_steps_served": self.cached_steps_served,
                "computed_steps_served": self.computed_steps_served,
                "stale_serves": self.stale_serves,
            }
