"""Query planner of the port: materializes LogicalPlans into executable
plans over a pruned shard subset (the counterpart of
``filodb_tpu.query.planner``, single-node path).

Shard pruning is the reference's (SingleClusterPlanner.scala:872
shardsFromFilters): equality filters on the shard-key columns (_ws_, _ns_,
metric) hash to a shard subset via the bit-compatible `query_shards`
(RecordBuilder.scala:667 shardKeyHash + spread bit split); anything else
fans out to all queryable shards. Every plan runs as a `LocalEngineExec`:
the single-process engine over that subset, with the port's device
backend.

Not ported yet: the mesh lowerings (`MeshTileExec`, `MeshAggregateExec`),
the remote, gRPC and pushdown exec paths (they need peers), cross-cluster
partition routing and the raw/downsample tiering. The reference's planner
hands its per-query deadline, partial-result flag and cache bypass only to
those paths (`LocalEngineExec` takes none of them), so this planner takes
none either.
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.record import shard_key_hash
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.engine import METRIC_LABELS, QueryEngine
from filodb_tpu_torch.query.model import (GridResult, QueryLimits,
                                          QueryStats)

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


# plan node types whose evaluation range lp_replace_range can rewrite —
# the plan and results caches rebase only these shapes
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


class ExecPlan:
    """Materialized plan node (query/exec/ExecPlan.scala:46)."""

    def execute(self):
        raise NotImplementedError


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
            # degraded leaf dispatch inside the engine: stamp the grid so
            # every aggregation above carries the flag
            out.partial = True
            out.warnings.extend(w for w in eng.stats.warnings
                                if w not in out.warnings)
        return out


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
                 limits: Optional[QueryLimits] = None,
                 spread_provider: Optional[object] = None):
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
        self.limits = limits        # per-query guardrails (None = off)
        self.stats = QueryStats()
        # tenant QoS (query/qos.py): a TenantMetering snapshot, when wired,
        # prices shard groups the local cardinality trackers do not know
        self.metering = None

    def estimate_cost(self, plan):
        """Pre-admission price of a plan over THIS planner's shard view
        (query/qos.py): shard-key cardinality from the local trackers /
        tag-index postings, grid step count and plan shape."""
        from filodb_tpu_torch.query import qos
        return qos.estimate_plan_cost(plan, self.shards,
                                      metering=self.metering)

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
            nums = sorted(self._by_num)
        if self.mapper is not None:
            ok = set(self.mapper.active_shards(nums))
            down = [n for n in nums if n not in ok]
            nums = [n for n in nums if n in ok]
            if down:
                self.stats.warnings.append(
                    "shards " + ",".join(map(str, down))
                    + " are down with no replica; results are partial")
        return [self._by_num[n] for n in nums if n in self._by_num]

    # -- materialization -------------------------------------------------
    def materialize(self, plan) -> ExecPlan:
        """(SingleClusterPlanner.scala:253): the engine over the pruned
        shard subset."""
        return LocalEngineExec(plan, self._resolve_shards(plan),
                               self.backend, self.stats, self.limits)

    def execute(self, plan):
        return self.materialize(plan).execute()
