"""Query planner of the port: materializes LogicalPlans into executable
plans over a pruned shard subset (the counterpart of
``filodb_tpu.query.planner``).

Shard pruning is the reference's (SingleClusterPlanner.scala:872
shardsFromFilters): equality filters on the shard-key columns (_ws_, _ns_,
metric) hash to a shard subset via the bit-compatible `query_shards`
(RecordBuilder.scala:667 shardKeyHash + spread bit split); anything else
fans out to all queryable shards.

In a cluster (``peers``), shards owned by a peer become remote shard
groups that stand in the shard list: the engine's leaf selection fetches
their raw series over gRPC (``grpc_peers``) or HTTP, and the whole plan
evaluates on the entry node through its own tiles and kernels. A plan
whose every shard lives on one peer is forwarded whole; a same-metric
join with no ``on``/``ignoring`` is pushed down to every owning node
(``ConcatExec``); a query pinning ``_ws_`` to another cluster's partition
is forwarded there. DOWN shards route to a buddy replica when one is
configured. The per-query deadline and ``allow_partial`` act on these
remote paths, as in the reference.

Raw/downsample tiering (LongTimeRangePlanner.scala:30): with a
``ds_store`` and ``raw_retention_ms``, a plan whose step windows reach
before ``now - raw_retention_ms`` splits into a downsample-side exec over
the ds store's shards and a raw-side exec, stitched on the step grid
(``StitchExec``). Downsampled chunks are ordinary chunks, so both sides run
through the same engine, backend and kernels.

Not ported yet: the mesh lowerings (`MeshTileExec`, `MeshAggregateExec`,
ROADMAP A.11).
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.record import shard_key_hash
from filodb_tpu_torch.lint.caches import publishes
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.engine import METRIC_LABELS, QueryEngine
from filodb_tpu_torch.query.model import (GridResult, QueryError,
                                          QueryLimits, QueryStats,
                                          StaleRoutingError)

# a regex that is just literal alternations (no metacharacters beyond |)
_LITERAL_ALT = re.compile(r"[A-Za-z0-9_\-:, ]+$")


def _shard_key_candidates(f: ColumnFilter) -> Optional[List[str]]:
    """Concrete candidate values a filter pins its label to, or None."""
    if f.op == "eq":
        return [f.value]
    if f.op == "in":
        vals = f.value if isinstance(f.value, (list, tuple)) \
            else str(f.value).split(",")
        return [str(v) for v in vals]
    if f.op == "re" and "|" in f.value:
        parts = f.value.split("|")
        if all(p and _LITERAL_ALT.match(p) for p in parts):
            return parts
    return None


def walk_plan_tree(plan, visit) -> None:
    """Depth-first walk over a LogicalPlan's dataclass tree (the shared
    recursion of walkLogicalPlanTree). ``visit(node) -> bool``: return
    True to stop descending into that node's children."""
    if plan is None or not hasattr(plan, "__dataclass_fields__"):
        return
    if visit(plan):
        return
    for f in plan.__dataclass_fields__:
        v = getattr(plan, f)
        if isinstance(v, tuple):
            for item in v:
                walk_plan_tree(item, visit)
        else:
            walk_plan_tree(v, visit)


def walk_leaf_filters(plan) -> List[Tuple[ColumnFilter, ...]]:
    """Collect the filter sets of every RawSeries leaf under a plan
    (walkLogicalPlanTree's shard resolution inputs)."""
    out: List[Tuple[ColumnFilter, ...]] = []

    def visit(p):
        if isinstance(p, lp.RawSeriesPlan):
            out.append(tuple(p.filters))
            return True
        return False

    walk_plan_tree(plan, visit)
    return out


@dataclass
class PlannerParams:
    """(core/query/QueryContext PlannerParams equivalent)."""
    spread: int = 0
    sample_limit: int = 0       # 0 = unlimited (guardrails layer)
    series_limit: int = 0


def plan_range(plan) -> Optional[Tuple[int, int, int, int, int]]:
    """(start_ms, step_ms, end_ms, min_window_ms, max_lookback_ms) of the
    evaluation grid shared by all periodic nodes, or None when the plan has
    no periodic node or the nodes disagree (e.g. nested subquery grids).
    min_window governs downsample resolution choice (every selector must
    tolerate the chosen period); max_lookback additionally includes
    offsets — the earliest data instant any step can touch is
    ``start - max_lookback``."""
    grids: List[Tuple[int, int, int]] = []
    window = [1 << 62]
    lookback = [0]

    def visit(p):
        if isinstance(p, (lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing)):
            grids.append((p.start_ms, p.step_ms, p.end_ms))
            w = p.lookback_ms if isinstance(p, lp.PeriodicSeries) \
                else p.window_ms
            window[0] = min(window[0], w)
            lookback[0] = max(lookback[0], w + p.offset_ms)
            return True
        return False

    walk_plan_tree(plan, visit)
    if not grids or any(g != grids[0] for g in grids[1:]):
        return None
    s, st, e = grids[0]
    return s, st, e, window[0], lookback[0]


def _collect_at(plan) -> Tuple[List[int], int]:
    """(@-pinned instants, total periodic-node count) under a plan."""
    ats: List[int] = []
    count = [0]

    def visit(p):
        if isinstance(p, (lp.PeriodicSeries,
                          lp.PeriodicSeriesWithWindowing)):
            count[0] += 1
            if p.at_ms is not None:
                ats.append(p.at_ms)
            return True
        return False

    walk_plan_tree(plan, visit)
    return ats, count[0]


# plan node types whose evaluation range lp_replace_range can rewrite —
# only these shapes may be split across the raw/downsample boundary (and
# the plan and results caches rebase only these)
_SPLITTABLE = (
    lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing, lp.Aggregate,
    lp.BinaryJoin, lp.ScalarVectorBinaryOperation, lp.ApplyInstantFunction,
    lp.ApplyMiscellaneousFunction, lp.ApplySortFunction,
    lp.ApplyLimitFunction, lp.ApplyAbsentFunction, lp.ScalarTimeBasedPlan,
    lp.ScalarFixedDoublePlan, lp.ScalarVaryingDoublePlan,
    lp.ScalarBinaryOperation, lp.VectorPlan, lp.RawSeriesPlan,
)


def _splittable(plan) -> bool:
    if not hasattr(plan, "__dataclass_fields__") \
            or isinstance(plan, ColumnFilter):
        return True     # literals / filters
    if not isinstance(plan, _SPLITTABLE):
        return False
    if getattr(plan, "at_ms", None) is not None:
        return False    # @-pinned evaluation doesn't split on the grid
    for f in plan.__dataclass_fields__:
        v = getattr(plan, f)
        if isinstance(v, tuple):
            if not all(_splittable(x) for x in v):
                return False
        elif hasattr(v, "__dataclass_fields__"):
            if not _splittable(v):
                return False
    return True


def stitch_grids(first: GridResult, second: GridResult) -> GridResult:
    """Merge two grid results onto the union step grid, matching series by
    label key; on a shared step the first's non-NaN sample wins
    (StitchRvsExec.scala:116 / :105 merge semantics)."""
    if first.num_series == 0 and first.steps.size == 0:
        return second
    if second.num_series == 0 and second.steps.size == 0:
        return first
    steps = np.union1d(first.steps, second.steps)
    hist = first.is_hist() or second.is_hist()
    if hist:
        les = first.bucket_les if first.is_hist() else second.bucket_les
        if (first.is_hist() and second.is_hist()
                and not np.array_equal(first.bucket_les,
                                       second.bucket_les)):
            raise QueryError("cannot stitch histogram results with "
                             "different bucket schemes")
        nb = les.size
    key_ix: Dict[Tuple, int] = {}
    keys: List[Dict[str, str]] = []
    rows: List[np.ndarray] = []
    hrows: List[np.ndarray] = []
    for side in (first, second):
        if side.num_series == 0:
            continue
        pos = np.searchsorted(steps, side.steps)
        for i, k in enumerate(side.keys):
            fk = tuple(sorted(k.items()))
            j = key_ix.get(fk)
            if j is None:
                j = len(keys)
                key_ix[fk] = j
                keys.append(dict(k))
                rows.append(np.full(steps.size, np.nan))
                if hist:
                    hrows.append(np.full((steps.size, nb), np.nan))
            cur = rows[j][pos]
            rows[j][pos] = np.where(np.isnan(cur), side.values[i], cur)
            if hist and side.is_hist():
                curh = hrows[j][pos]
                hrows[j][pos] = np.where(np.isnan(curh),
                                         side.hist_values[i], curh)
    values = np.vstack([r[None] for r in rows]) if rows else \
        np.zeros((0, steps.size))
    hv = np.stack(hrows) if hist and hrows else None
    return GridResult(steps, keys, values, hist_values=hv,
                      bucket_les=les if hist else None)


class ExecPlan:
    """Materialized plan node (query/exec/ExecPlan.scala:46)."""

    def execute(self):
        raise NotImplementedError

    def plan_tree(self, indent: int = 0) -> str:
        return " " * indent + type(self).__name__


@dataclass
class ConcatExec(ExecPlan):
    """Concatenate children's series onto one grid (the reference's
    LocalPartitionDistConcatExec over pushed-down per-shard plans,
    exec/DistConcatExec.scala). Children evaluate disjoint series sets
    (each series lives on exactly one shard), so plain concatenation is
    the correct union.

    Degraded mode: with ``allow_partial`` a child that fails with a
    QueryError (peer exhausted, breaker open) is dropped and the result
    is flagged partial with a warning naming the lost child; default
    remains fail-fast. ``deadline`` is checked between children so an
    exhausted budget stops the fan-out cleanly."""
    children: Sequence[ExecPlan]
    stats: QueryStats
    allow_partial: bool = False
    deadline: Optional[object] = None

    def execute(self):
        outs = []
        dropped: List[str] = []
        for c in self.children:
            if self.deadline is not None:
                self.deadline.check("ConcatExec fan-out")
            try:
                outs.append(c.execute())
            except StaleRoutingError:
                # never absorbed into a partial result: the entry node
                # re-resolves routing and retries the whole query
                raise
            except QueryError as e:
                if not self.allow_partial:
                    raise
                who = c.plan_tree().strip()
                dropped.append(f"partial result: {who} failed ({e})")
        if not outs:
            if dropped:
                raise QueryError(
                    "all shard groups failed: " + "; ".join(dropped))
            raise QueryError("ConcatExec has no children")
        grids = [o for o in outs if isinstance(o, GridResult)]
        if not grids:
            return outs[0]
        steps = grids[0].steps
        keys = [k for g in grids for k in g.keys]
        vals = (np.concatenate([g.values for g in grids], axis=0)
                if grids else np.zeros((0, steps.size)))
        hv = None
        les = None
        if any(g.hist_values is not None for g in grids):
            hvs = [g.hist_values for g in grids
                   if g.hist_values is not None]
            nb = max(h.shape[2] for h in hvs)
            # children must agree on the bucket scheme: the les of every
            # child must be a prefix of the max-width child's, or the
            # padded concat would silently mix incompatible buckets
            les = max((g.bucket_les for g in grids
                       if g.bucket_les is not None), key=len)
            for g in grids:
                gl = g.bucket_les
                if gl is not None and not np.array_equal(
                        np.asarray(gl), np.asarray(les)[:len(gl)]):
                    raise QueryError(
                        "cannot concatenate histogram results with "
                        f"mismatched bucket schemes ({list(gl)} vs "
                        f"{list(les)})")
            hv = np.concatenate(
                [np.pad(h, ((0, 0), (0, 0), (0, nb - h.shape[2])),
                        constant_values=np.nan) for h in hvs], axis=0)
        out = GridResult(steps, keys, vals, hist_values=hv,
                         bucket_les=les).absorb_degraded(*grids)
        if dropped:
            out.partial = True
            out.warnings.extend(dropped)
            self.stats.partial = True
            self.stats.warnings.extend(dropped)
        return out

    def plan_tree(self, indent: int = 0) -> str:
        pads = " " * indent
        kids = "\n".join(c.plan_tree(indent + 2) for c in self.children)
        return f"{pads}ConcatExec\n{kids}"


@dataclass
class LocalEngineExec(ExecPlan):
    """Evaluate a LogicalPlan on the single-process engine over a pruned
    shard subset (InProcessPlanDispatcher.scala:25 semantics)."""
    plan: object
    shards: Sequence[object]
    backend: Optional[object]
    stats: QueryStats
    limits: Optional[QueryLimits] = None

    def execute(self):
        eng = QueryEngine(self.shards, backend=self.backend,
                          limits=self.limits)
        out = eng.execute(self.plan)
        self.stats.add(eng.stats)
        if isinstance(out, GridResult) and eng.stats.partial:
            # degraded leaf dispatch inside the engine (a shard group
            # dropped under allow_partial): stamp the grid so every
            # aggregation above carries the flag
            out.partial = True
            out.warnings.extend(w for w in eng.stats.warnings
                                if w not in out.warnings)
        return out

    def plan_tree(self, indent: int = 0) -> str:
        pads = " " * indent
        shard_nums = [getattr(s, "shard_num", "?") for s in self.shards]
        return (f"{pads}LocalEngineExec(shards={shard_nums}, "
                f"plan={type(self.plan).__name__})")


@dataclass
class StitchExec(ExecPlan):
    """Raw/downsample time split: the downsample exec covers the steps
    whose lookback windows fall beyond raw retention, the raw exec covers
    the recent steps; results merge on the step grid
    (LongTimeRangePlanner.scala:30 + StitchRvsExec.scala:116)."""
    ds_exec: Optional[ExecPlan]
    raw_exec: Optional[ExecPlan]

    def execute(self):
        parts = [e.execute() for e in (self.ds_exec, self.raw_exec)
                 if e is not None]
        parts = [p for p in parts if isinstance(p, GridResult)]
        if not parts:
            raise QueryError("stitch produced no grid results")
        if len(parts) == 1:
            return parts[0]
        return stitch_grids(parts[0], parts[1]).absorb_degraded(*parts)

    def plan_tree(self, indent: int = 0) -> str:
        pads = " " * indent
        kids = [e.plan_tree(indent + 2)
                for e in (self.ds_exec, self.raw_exec) if e is not None]
        return f"{pads}StitchExec(\n" + "\n".join(kids) + ")"


class QueryPlanner:
    """materialize(LogicalPlan) -> ExecPlan (QueryPlanner.scala:17;
    SingleClusterPlanner.scala:52). Also the execution facade the HTTP
    layer calls (`execute` = materialize + run)."""

    def __init__(self, shards: Sequence[object],
                 backend: Optional[object] = None,
                 shard_mapper: Optional[object] = None,
                 spread: int = 1,   # system default-spread; must match ingest
                 shard_key_columns: Tuple[str, ...] = ("_ws_", "_ns_"),
                 metric_column: str = "_metric_",
                 ds_store: Optional[object] = None,
                 raw_retention_ms: int = 0,
                 now_ms=None,
                 limits: Optional[QueryLimits] = None,
                 spread_provider: Optional[object] = None,
                 node_id: Optional[str] = None,
                 peers: Optional[Dict[str, str]] = None,
                 buddies: Optional[Dict[str, str]] = None,
                 partitions: Optional[Dict[str, str]] = None,
                 local_partitions: Optional[Sequence[str]] = None,
                 dataset: str = "timeseries",
                 grpc_peers: Optional[Dict[str, str]] = None,
                 grpc_partitions: Optional[Dict[str, str]] = None,
                 deadline: Optional[object] = None,
                 allow_partial: bool = False,
                 resilience: Optional[object] = None,
                 no_result_cache: bool = False,
                 local_dispatch: bool = False,
                 handoff_sources: Optional[Dict[int, Tuple[str, str]]]
                 = None,
                 peer_watermarks: Optional[Dict[str, Dict]] = None,
                 plane_fallbacks: Optional[object] = None):
        self.shards = list(shards)
        self._by_num = {getattr(s, "shard_num", i): s
                        for i, s in enumerate(self.shards)}
        self.backend = backend
        self.mapper = shard_mapper
        self.spread = spread
        # per-shard-key spread overrides (core/SpreadProvider.scala); must
        # be the same provider the ingest edge routes with
        self.spread_provider = spread_provider
        self.shard_key_columns = tuple(shard_key_columns)
        self.metric_column = metric_column
        # raw/downsample tiering (LongTimeRangePlanner.scala:30): queries
        # reaching beyond `now - raw_retention_ms` split to the ds_store
        self.ds_store = ds_store
        self.raw_retention_ms = int(raw_retention_ms)
        self.now_ms = now_ms        # int | callable | None (= wall clock)
        self.limits = limits        # per-query guardrails (None = off)
        # multi-process: this node's id + peer node_id -> base URL; shard
        # numbers the mapper assigns to peers dispatch remotely
        # (FiloDbClusterDiscovery.scala:50 / PlanDispatcher.scala:21)
        self.node_id = node_id
        self.peers = dict(peers or {})
        # HA replica cluster: node_id -> buddy base URL holding the same
        # shard layout; DOWN shards route there instead of dropping out
        # (HighAvailabilityPlanner.scala:31,285 / BuddyShardMapper)
        self.buddies = dict(buddies or {})
        # cross-cluster federation: workspace (_ws_) value -> base URL of
        # the cluster owning that partition (MultiPartitionPlanner.scala:53
        # / SinglePartitionPlanner.scala:17 — pick the cluster by key and
        # forward the whole query; the remote cluster plans freely)
        self.partitions = dict(partitions or {})
        # workspaces THIS cluster serves; never forwarded (self-loop guard)
        self.local_partitions = frozenset(local_partitions or ())
        self.dataset = dataset
        # binary data plane: node/workspace -> grpc host:port; when a peer
        # advertises one, leaf dispatch and pushdown ride protobuf +
        # NibblePack over a persistent channel instead of base64-JSON
        # (grpcsvc; PromQLGrpcServer.scala:44)
        self.grpc_peers = dict(grpc_peers or {})
        self.grpc_partitions = dict(grpc_partitions or {})
        # the entry node's count of gRPC -> HTTP downgrades
        # (grpcsvc.client.PlaneFallbacks), handed to every gRPC group
        self.plane_fallbacks = plane_fallbacks
        # degraded-mode execution (parallel/resilience.py): per-query
        # deadline budget + opt-in partial results; the retry policy and
        # breaker registry are server-lifetime (breaker state must
        # outlive one query)
        self.deadline = deadline
        self.allow_partial = bool(allow_partial)
        # &cache=false propagation: a bypassed query must stay bypassed
        # across whole-query pushdown hops (the peer consults its OWN
        # results cache otherwise)
        self.no_result_cache = bool(no_result_cache)
        # dispatch scope: True when this planner is pinned to local
        # shards (&dispatch=local pushdown hop / gRPC local_only). A
        # local-only evaluation sees a SUBSET of the world a fan-out
        # query sees — the results cache keys on this so the two can
        # never serve each other's extents
        self.local_dispatch = bool(local_dispatch)
        # mid-handoff read redirect (parallel/membership.py): shard ->
        # (previous owner node, base URL) for shards THIS node is
        # adopting but has not finished replaying — reads route to the
        # still-serving previous owner so no query sees a half-replayed
        # copy (the make-before-break read path)
        self.handoff_sources = dict(handoff_sources or {})
        # gossiped per-peer ingest watermarks + backfill epochs (health
        # body, ROADMAP 4a): stamped onto remote shard groups so the
        # results cache's freshness horizon covers fan-out extents
        self.peer_watermarks = dict(peer_watermarks or {})
        if resilience is None:
            from filodb_tpu_torch.parallel.resilience import PeerResilience
            resilience = PeerResilience.default()
        self.resilience = resilience
        self.stats = QueryStats()
        # tenant QoS (query/qos.py): the node's TenantMetering snapshot,
        # when wired, prices remote shard groups in estimate_cost (local
        # cardinality trackers only know local shards)
        self.metering = None

    def estimate_cost(self, plan):
        """Pre-admission price of a plan over THIS planner's shard view
        (query/qos.py): shard-key cardinality from the local trackers /
        tag-index postings, the metering snapshot for fan-out groups,
        grid step count and plan shape. The one facade both the HTTP
        edge and the gRPC exec service charge budgets through."""
        from filodb_tpu_torch.query import qos
        return qos.estimate_plan_cost(plan, self.shards,
                                      metering=self.metering)

    def static_cost_bound(self, plan):
        """Static ceiling on :meth:`estimate_cost` for the same plan
        (promql/semant.py cost lattice): bound.total >= estimate_cost
        (plan).total for every plan shape — the QoS cross-check pinned
        by tests/test_promql_cost_bound.py, surfaced under
        ``&explain=analyze``."""
        from filodb_tpu_torch.promql.semant import static_cost_bound
        return static_cost_bound(plan, self.shards,
                                 metering=self.metering)

    def _remote_kw(self) -> Dict:
        """Resilience kwargs shared by every remote shard group."""
        return dict(retry=self.resilience.retry,
                    breakers=self.resilience.breakers,
                    deadline=self.deadline,
                    allow_partial=self.allow_partial)

    def _exec_kw(self) -> Dict:
        """Resilience kwargs for whole-query remote exec nodes (partial
        tolerance lives in the surrounding ConcatExec, not the hop)."""
        return dict(retry=self.resilience.retry,
                    breakers=self.resilience.breakers,
                    deadline=self.deadline,
                    no_cache=self.no_result_cache)

    # -- shard pruning (shardsFromFilters, SingleClusterPlanner.scala:872) --
    def shards_from_filters(self, filters: Sequence[ColumnFilter]
                            ) -> Optional[List[int]]:
        """Shard subset for one leaf, or None when filters can't resolve a
        shard key (fan out to all).

        Shard-key columns matched by a regex of LITERAL ALTERNATIONS
        (``App-0|App-1``) or an explicit ``in`` list expand into per-value
        shard sets and union — the ShardKeyRegexPlanner.scala:31 fan-out
        (the reference likewise only supports | of literals)."""
        if self.mapper is None:
            return None
        by_label: Dict[str, List[str]] = {}
        for f in filters:
            vals = _shard_key_candidates(f)
            if vals is not None and f.label not in by_label:
                by_label[f.label] = vals
        metric_vals = None
        for ml in (self.metric_column,) + METRIC_LABELS:
            if ml in by_label:
                metric_vals = by_label[ml]
                break
        if metric_vals is None:
            return None
        key_cols = [c for c in self.shard_key_columns
                    if c != self.metric_column]
        per_col = []
        for c in key_cols:
            if c not in by_label:
                return None
            per_col.append(by_label[c])
        # cartesian fan-out over the candidate key tuples (bounded small;
        # math.prod: exact Python ints — np.prod would wrap at 2^64 and
        # could sneak a huge fan-out past the cap)
        if math.prod(len(v) for v in per_col + [metric_vals]) > 256:
            return None     # oversized fan-out: just use all shards
        nums: set = set()
        for combo in itertools.product(*per_col):
            spread = self.spread_provider.spread_for(list(combo)) \
                if self.spread_provider is not None else self.spread
            for metric in metric_vals:
                skh = shard_key_hash(list(combo), metric)
                nums.update(self.mapper.query_shards(skh, spread))
        return sorted(nums)

    def _resolve_shards(self, plan) -> List[object]:
        """Union of pruned shard subsets across all leaves; all shards when
        any leaf can't be pruned."""
        leaves = walk_leaf_filters(plan)
        if not leaves:
            return self._queryable(None)
        nums: set = set()
        for filters in leaves:
            subset = self.shards_from_filters(filters)
            if subset is None:
                return self._queryable(None)
            nums.update(subset)
        return self._queryable(sorted(nums))

    def _queryable(self, nums: Optional[List[int]]) -> List[object]:
        if nums is None:
            nums = sorted(self._by_num) if not self.peers else \
                list(range(self.mapper.num_shards)) if self.mapper \
                else sorted(self._by_num)
        down: List[int] = []
        if self.mapper is not None:
            from filodb_tpu_torch.parallel.shardmapper import ShardStatus
            ok = set(self.mapper.active_shards(nums))
            down = [n for n in nums if n not in ok]
            nums = [n for n in nums if n in ok]
            # flag, don't hide: a peer-owned shard still in RECOVERY
            # (its adopter is bootstrapping/replaying) serves what it
            # has — the response carries a partial-result warning
            for n in nums:
                if n not in self._by_num and \
                        self.mapper.status(n) is ShardStatus.RECOVERY:
                    self.stats.warnings.append(
                        f"shard {n} is recovering on "
                        f"{self.mapper.node_of(n)}; results may be "
                        f"partial")
            if down and not self.buddies:
                self.stats.warnings.append(
                    "shards " + ",".join(map(str, down))
                    + " are down with no replica; results are partial")
        # make-before-break read path: shards mid-adoption here are
        # served by their previous owner until the replay flips ACTIVE
        redirect: Dict[Tuple[str, str], List[int]] = {}
        redirected: set = set()
        for n in nums:
            if n in self._by_num and n in self.handoff_sources:
                node, url = self.handoff_sources[n]
                redirect.setdefault((node, url), []).append(n)
                redirected.add(n)
        local = [self._by_num[n] for n in nums
                 if n in self._by_num and n not in redirected]
        if redirect:
            from filodb_tpu_torch.parallel.cluster import RemoteShardGroup
            for (node, url), group in sorted(redirect.items()):
                grp = RemoteShardGroup(node, url, self.dataset, group,
                                       **self._remote_kw())
                self._stamp_peer_freshness(grp, node, group)
                local.append(grp)
        if down and self.buddies:
            # failover: serve a down shard from the buddy replica of its
            # owning node (the replica ingests the same stream)
            from filodb_tpu_torch.parallel.cluster import RemoteShardGroup
            by_buddy: Dict[str, List[int]] = {}
            for n in down:
                node = self.mapper.node_of(n)
                url = self.buddies.get(node or "")
                if url:
                    by_buddy.setdefault(url, []).append(n)
            for i, (url, group) in enumerate(sorted(by_buddy.items())):
                local.append(RemoteShardGroup(f"buddy:{url}", url,
                                              self.dataset, group,
                                              **self._remote_kw()))
        if not self.peers or self.mapper is None:
            return local
        # group non-local shard numbers by their owning peer node
        from filodb_tpu_torch.parallel.cluster import RemoteShardGroup
        by_node: Dict[str, List[int]] = {}
        for n in nums:
            if n in self._by_num:
                continue
            node = self.mapper.node_of(n)
            if node is None or node == self.node_id \
                    or node not in self.peers:
                continue
            by_node.setdefault(node, []).append(n)
        for node, group in sorted(by_node.items()):
            gaddr = self.grpc_peers.get(node)
            if gaddr:
                from filodb_tpu_torch.grpcsvc import GrpcShardGroup
                grp = GrpcShardGroup(
                    node, gaddr, self.dataset, group,
                    http_fallback=self.peers.get(node),
                    fallbacks=self.plane_fallbacks,
                    **self._remote_kw())
            else:
                grp = RemoteShardGroup(node, self.peers[node],
                                       self.dataset, group,
                                       **self._remote_kw())
            self._stamp_peer_freshness(grp, node, group)
            local.append(grp)
        return local

    # remote-group twin of the memstore's watermark/backfill publishers:
    # gossip-stamped attributes the results cache reads exactly like
    # local shard state
    @publishes("watermark")
    @publishes("backfill-epoch")
    def _stamp_peer_freshness(self, grp, node: str,
                              group: Sequence[int]) -> None:
        """Stamp a remote shard group with the peer's gossiped ingest
        watermark + backfill-epoch sum (health-body exchange, ROADMAP
        4a) when the gossip covers EVERY shard in the group. The
        results cache reads these exactly like local shard attributes,
        so fan-out extents gain the same settled-time bound local
        extents have had — instead of leaning on the hot window alone.
        Partial coverage stamps nothing (conservative: the group stays
        invisible to the freshness horizon, as before)."""
        pw = self.peer_watermarks.get(node)
        if not pw:
            return
        wms = [pw.get("watermarks", {}).get(int(n)) for n in group]
        if not wms or any(w is None for w in wms):
            return
        # -1 entries are never-ingested peer shards: they constrain
        # nothing (mirroring local semantics) but are COUNTED OUT of
        # the coverage, so the results cache sees the moment one of
        # them starts ingesting even if the min never moves
        nonneg = [int(w) for w in wms if int(w) >= 0]
        grp.ingest_watermark_ms = min(nonneg) if nonneg else -1
        grp.ingest_watermark_coverage = len(nonneg)
        grp.ingest_backfill_epoch = sum(
            int(pw.get("epochs", {}).get(int(n), 0)) for n in group)

    # -- materialization -------------------------------------------------
    def materialize(self, plan) -> ExecPlan:
        """(SingleClusterPlanner.scala:253). Cross-cluster partition
        routing first, then raw/downsample tiering (LongTimeRangePlanner),
        then whole-query pushdown to the one peer owning every shard, then
        shard-aligned join pushdown; everything else runs on this node
        over the pruned shard subset, with peers' shards as remote shard
        groups."""
        fed = self._try_partition_routing(plan)
        if fed is not None:
            return fed
        tiered = self._try_tiering(plan)
        if tiered is not None:
            return tiered
        return self._materialize_raw(plan)

    def _materialize_raw(self, plan) -> ExecPlan:
        pushed = self._try_remote_pushdown(plan)
        if pushed is not None:
            return pushed
        pushed = self._try_pushdown_join(plan)
        if pushed is not None:
            return pushed
        return LocalEngineExec(plan, self._resolve_shards(plan),
                               self.backend, self.stats, self.limits)

    def _plan_shard_set(self, plan) -> Optional[frozenset]:
        """Pruned shard-number set of a (sub)plan, or None when any leaf
        can't prune."""
        leaves = walk_leaf_filters(plan)
        if not leaves:
            return None
        nums: set = set()
        for filters in leaves:
            subset = self.shards_from_filters(filters)
            if subset is None:
                return None
            nums.update(subset)
        return frozenset(nums)

    def _try_pushdown_join(self, plan) -> Optional[ExecPlan]:
        """Per-node shard-aligned binary-join pushdown
        (SingleClusterPlanner.scala:649 materializeWithPushdown /
        LogicalPlanUtils.getPushdownKeys): when every matching pair of
        series is provably CO-LOCATED, each owning node evaluates the
        join over its local shards and the entry node concatenates
        joined results — raw series never cross the network.

        Co-location proof under this framework's shard routing
        (ingestion_shard hashes ws/ns/METRIC plus the part hash): both
        sides must select the SAME single metric and match on the full
        label set (no on/ignoring) — then matching series have identical
        labels, identical hashes, and the same shard. The reference
        proves the on-clause case via target schemas
        (sameRawSeriesTargetSchemaColumns); without target schemas those
        joins stay on the entry node."""
        if not isinstance(plan, lp.BinaryJoin) or not self.peers \
                or self.mapper is None:
            return None
        if getattr(plan, "on", None) or getattr(plan, "ignoring", ()):
            return None
        metrics = set()
        for filters in walk_leaf_filters(plan):
            got = [f.value for f in filters
                   if f.label in (self.metric_column,) + METRIC_LABELS
                   and f.op == "eq"]
            if len(got) != 1:
                return None
            metrics.add(got[0])
        if len(metrics) != 1:
            return None
        lshards = self._plan_shard_set(plan.lhs)
        rshards = self._plan_shard_set(plan.rhs)
        if lshards is None or rshards is None or lshards != rshards:
            return None
        nums = sorted(lshards)
        if set(self.mapper.active_shards(nums)) != set(nums):
            return None          # down shards: let the general path warn
        by_node: Dict[str, List[int]] = {}
        for n in nums:
            node = self.mapper.node_of(n)
            if node is None:
                return None
            by_node.setdefault(node, []).append(n)
        if len(by_node) < 2:
            return None          # single node: whole-query pushdown owns it
        fw = self._forwardable(plan)
        if fw is None:
            return None
        query, start, step, end = fw
        children: List[ExecPlan] = []
        for node, group in sorted(by_node.items()):
            if node == self.node_id:
                local = [self._by_num[n] for n in group
                         if n in self._by_num]
                children.append(LocalEngineExec(
                    plan, local, self.backend, self.stats, self.limits))
                continue
            gaddr = self.grpc_peers.get(node)
            if gaddr:
                from filodb_tpu_torch.grpcsvc import GrpcRemoteExec
                pw = self._plan_wire_of(plan)
                children.append(GrpcRemoteExec(
                    query, start, step, end, node, gaddr, self.dataset,
                    stats=self.stats, local_only=True,
                    plan_wire=pw[0] if pw else b"",
                    http_fallback=self.peers.get(node),
                    expect_shards=group,
                    fallbacks=self.plane_fallbacks,
                    **self._exec_kw()))
            elif node in self.peers:
                from filodb_tpu_torch.parallel.cluster import PromQlRemoteExec
                children.append(PromQlRemoteExec(
                    query, start, step, end, node, self.peers[node],
                    self.dataset, stats=self.stats, local_only=True,
                    expect_shards=group,
                    **self._exec_kw()))
            else:
                return None
        return ConcatExec(children, self.stats,
                          allow_partial=self.allow_partial,
                          deadline=self.deadline)

    def _try_remote_pushdown(self, plan) -> Optional[ExecPlan]:
        """Whole-query forwarding when EVERY pruned shard lives on ONE
        peer node and the plan prints back to PromQL — this is also the
        shard-aligned binary-join pushdown (SingleClusterPlanner.scala:649:
        joins execute where the data is when both sides target the same
        shards; here "where the data is" is the owning peer)."""
        if not self.peers or self.mapper is None:
            return None
        if lp.is_metadata_plan(plan) or lp.is_scalar_plan(plan):
            return None
        shards = self._resolve_shards(plan)
        if not shards or not all(hasattr(s, "fetch_raw") for s in shards):
            return None
        nodes = {s.node_id for s in shards}
        if len(nodes) != 1:
            return None
        g = shards[0]
        gaddr = self.grpc_peers.get(g.node_id)
        fw = self._forwardable(plan)
        expect = list(g.shard_nums) if g.shard_nums is not None else None
        if gaddr:
            # gRPC peers take the STRUCTURAL plan tree (exec_plan.proto
            # capability): no dependence on the PromQL printer, so even
            # unprintable plans (subqueries etc.) push down whole
            pw = self._plan_wire_of(plan)
            if pw is not None:
                wire_bytes, start, step, end = pw
                from filodb_tpu_torch.grpcsvc import GrpcRemoteExec
                return GrpcRemoteExec(
                    fw[0] if fw else f"<plan:{type(plan).__name__}>",
                    start, step, end, g.node_id, gaddr, g.dataset,
                    stats=self.stats, plan_wire=wire_bytes,
                    http_fallback=(self.peers.get(g.node_id)
                                   if fw else None),
                    expect_shards=expect,
                    fallbacks=self.plane_fallbacks,
                    **self._exec_kw())
        if fw is None:
            return None
        query, start, step, end = fw
        if gaddr:
            from filodb_tpu_torch.grpcsvc import GrpcRemoteExec
            return GrpcRemoteExec(query, start, step, end, g.node_id,
                                  gaddr, g.dataset, stats=self.stats,
                                  http_fallback=self.peers.get(g.node_id),
                                  expect_shards=expect,
                                  fallbacks=self.plane_fallbacks,
                                  **self._exec_kw())
        from filodb_tpu_torch.parallel.cluster import PromQlRemoteExec
        return PromQlRemoteExec(query, start, step, end, g.node_id,
                                g.base_url, g.dataset, stats=self.stats,
                                expect_shards=expect,
                                **self._exec_kw())

    def _plan_wire_of(self, plan):
        """(wire_bytes, start, step, end) when the plan serializes
        structurally and carries an evaluation range, else None."""
        rng = plan_range(plan)
        if rng is None:
            return None
        start, step, end, _, _ = rng
        try:
            from filodb_tpu_torch.query.planwire import plan_to_wire
            return plan_to_wire(plan), start, step, end
        except ValueError:
            return None

    def execute(self, plan):
        return self.materialize(plan).execute()

    def _forwardable(self, plan):
        """(query_text, start, step, end) when the whole plan can ride the
        HTTP edge to another node/cluster, else None — shared eligibility
        for pushdown and federation."""
        if lp.is_metadata_plan(plan) or lp.is_scalar_plan(plan):
            return None
        rng = plan_range(plan)
        if rng is None:
            return None
        start, step, end, _, _ = rng
        if start % 1000 or end % 1000 or (step > 0 and step % 1000):
            return None     # the HTTP edge carries second granularity
        from filodb_tpu_torch.query.planparser import plan_to_promql
        query = plan_to_promql(plan)
        if query is None:
            return None
        return query, start, step, end

    def _try_partition_routing(self, plan) -> Optional[ExecPlan]:
        """Forward a query whose every leaf pins _ws_ to ONE remote
        partition's cluster (SinglePartitionPlanner: cluster by key).
        Workspaces this cluster serves itself are never forwarded."""
        if not self.partitions:
            return None
        if lp.is_metadata_plan(plan) or lp.is_scalar_plan(plan):
            return None
        ws_values = set()
        for filters in walk_leaf_filters(plan):
            got = [f.value for f in filters
                   if f.label == "_ws_" and f.op == "eq"]
            if len(got) != 1:
                return None     # unpinned / multi: local planning
            ws_values.add(got[0])
        if len(ws_values) != 1:
            return None         # cross-partition joins stay local
        ws = ws_values.pop()
        if ws in self.local_partitions:
            return None         # our own partition: plan locally
        url = self.partitions.get(ws)
        if not url:
            return None
        fw = self._forwardable(plan)
        if fw is None:
            return None
        query, start, step, end = fw
        gaddr = self.grpc_partitions.get(ws)
        if gaddr:
            from filodb_tpu_torch.grpcsvc import GrpcRemoteExec
            return GrpcRemoteExec(query, start, step, end,
                                  f"partition:{gaddr}", gaddr,
                                  self.dataset, stats=self.stats,
                                  local_only=False, http_fallback=url,
                                  fallbacks=self.plane_fallbacks,
                                  **self._exec_kw())
        from filodb_tpu_torch.parallel.cluster import PromQlRemoteExec
        return PromQlRemoteExec(query, start, step, end,
                                f"partition:{url}", url, self.dataset,
                                stats=self.stats, local_only=False,
                                **self._exec_kw())

    # -- raw/downsample tiering (LongTimeRangePlanner.scala:30) -----------
    def _earliest_raw_ms(self) -> int:
        import time as _time
        if callable(self.now_ms):
            now = int(self.now_ms())
        elif self.now_ms is not None:
            now = int(self.now_ms)
        else:
            now = int(_time.time() * 1000)
        return now - self.raw_retention_ms

    def _try_tiering(self, plan) -> Optional[ExecPlan]:
        """Split a plan whose step windows reach beyond raw retention into
        a downsample-side exec and a raw-side exec, stitched. Returns None
        when tiering doesn't apply (all-raw, untierable shape, or no exact
        downsample mapping: those answer from the raw store)."""
        from filodb_tpu_torch.query.engine import lp_replace_range

        if self.ds_store is None or self.raw_retention_ms <= 0:
            return None
        if lp.is_metadata_plan(plan) or lp.is_scalar_plan(plan):
            return None
        rng = plan_range(plan)
        if rng is None:
            return None
        start, step, end, window, lookback = rng
        earliest_raw = self._earliest_raw_ms()
        ats, n_periodic = _collect_at(plan)
        if ats:
            # @-pinned selectors read at the pinned instant, not the grid:
            # when every selector is pinned beyond raw retention, the whole
            # plan routes to the downsample tier (no split: @ evaluates at
            # one instant and broadcasts)
            if len(ats) != n_periodic:
                return None                 # mixed pinned/unpinned: raw
            if min(ats) - lookback >= earliest_raw:
                return None                 # pinned data still in raw
            if max(ats) - lookback >= earliest_raw:
                # instants straddle the boundary: the ds tier may not
                # cover the recent one yet -> answer from raw
                return None
            eff_step = step if step > 0 else max(window, 1)
            picked = self.ds_store.plan_query(plan, max(window, 1),
                                              eff_step)
            if picked is None:
                return None
            ds_shards, ds_rewritten = picked
            return StitchExec(
                ds_exec=LocalEngineExec(ds_rewritten, ds_shards,
                                        self.backend, self.stats,
                                        self.limits),
                raw_exec=None)
        if start - lookback >= earliest_raw:
            return None                                  # fully in raw
        if not _splittable(plan):
            return None
        # first step whose whole lookback window sits inside raw retention
        if step > 0 and end - lookback >= earliest_raw:
            k = -((start - lookback - earliest_raw) // step)   # ceil div
            boundary = start + k * step
        elif end - lookback >= earliest_raw:
            boundary = start                             # single instant, raw
        else:
            boundary = None                              # fully beyond raw
        if boundary is not None and boundary <= start:
            return None                                  # fully in raw
        if boundary is None:
            ds_plan = plan
        else:
            ds_plan = lp_replace_range(plan, start, step, boundary - step)
        # instant queries (step<=0) have a single evaluation: resolution
        # choice is governed by the window alone
        eff_step = step if step > 0 else max(window, 1)
        picked = self.ds_store.plan_query(ds_plan, max(window, 1), eff_step)
        if picked is None:
            return None     # no exact ds mapping: answer from raw only
        ds_shards, ds_rewritten = picked
        ds_exec = LocalEngineExec(ds_rewritten, ds_shards, self.backend,
                                  self.stats, self.limits)
        raw_exec = None
        if boundary is not None and boundary <= end:
            raw_plan = lp_replace_range(plan, boundary, step, end)
            raw_exec = self._materialize_raw(raw_plan)
        return StitchExec(ds_exec=ds_exec, raw_exec=raw_exec)
