"""Query-side downsample store: resolution selection + plan rewriting
(the counterpart of ``filodb_tpu.downsample.store``).

(Reference: DownsampledTimeSeriesShard.scala:63 — query-only shards over
downsampled data, resolution chosen per query; the gauge query path reads
the ds-gauge column matching the range function. LongTimeRangePlanner
splits raw vs downsample by retention — the split/stitch lives in the
planner layer; this store answers the downsample side.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef, Schemas
from filodb_tpu_torch.downsample.job import ds_dataset
from filodb_tpu_torch.query import logical as lp

# range function -> (ds-gauge column, function to run over that column)
# min of per-period minima is the min; sums/counts add; avg falls back to
# the avg column (exact when windows nest periods, the standard ds tradeoff).
# last_over_time is deliberately absent: ds-gauge (matching the reference
# schema) has no `last` column, and mapping it to `avg` would silently
# return the period average — those queries fall back to raw data.
_GAUGE_REWRITES: Dict[str, Tuple[str, str]] = {
    "min_over_time": ("min", "min_over_time"),
    "max_over_time": ("max", "max_over_time"),
    "sum_over_time": ("sum", "sum_over_time"),
    "count_over_time": ("count", "sum_over_time"),
    "avg_over_time": ("avg", "avg_over_time"),
}


def select_resolution(resolutions: Sequence[int], window_ms: int,
                      step_ms: int) -> Optional[int]:
    """Coarsest resolution that still gives every window >= 2 periods
    (DownsampledTimeSeriesShard pickles resolution by query range)."""
    best = None
    for res in sorted(resolutions):
        if window_ms >= 2 * res and step_ms >= res:
            best = res
    return best


def rewrite_plan(plan, resolution_ms: int):
    """Rewrite a LogicalPlan to run against ds data: gauge over-time
    functions select the matching ds-gauge column. Counter functions
    (rate/increase) read the same value column and need no rewrite —
    counter downsampling preserved boundary samples.

    Returns None when the plan contains a window function the downsample
    schema cannot serve exactly (e.g. last_over_time, quantile_over_time on
    ds-gauge) — the caller must fall back to raw data."""
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        rw = _GAUGE_REWRITES.get(plan.function)
        if rw is None:
            from filodb_tpu_torch.query.rangefn import COUNTER_FUNCTIONS
            if plan.function in COUNTER_FUNCTIONS or plan.function == "delta":
                return plan     # counter ds preserved boundary samples
            # every other window function (changes, deriv, quantile_over_
            # time, holt_winters, ...) has no exact ds column: use raw
            return None
        col, func = rw
        raw = dataclasses.replace(plan.raw, column=plan.raw.column or col)
        return dataclasses.replace(plan, raw=raw, function=func)
    if hasattr(plan, "__dataclass_fields__"):
        changes = {}
        for f in plan.__dataclass_fields__:
            v = getattr(plan, f)
            if isinstance(v, tuple):
                nv = []
                for x in v:
                    if hasattr(x, "__dataclass_fields__"):
                        rx = rewrite_plan(x, resolution_ms)
                        if rx is None:
                            return None
                        nv.append(rx)
                    else:
                        nv.append(x)
                nv = tuple(nv)
                if nv != v:
                    changes[f] = nv
            elif hasattr(v, "__dataclass_fields__"):
                nv = rewrite_plan(v, resolution_ms)
                if nv is None:
                    return None
                if nv is not v:
                    changes[f] = nv
        if changes:
            return dataclasses.replace(plan, **changes)
    return plan


class DownsampledTimeSeriesStore:
    """Read-only store over the downsample datasets of one raw dataset.

    ``shards_for`` picks the resolution for a query and returns the shard
    set (bootstrapped lazily from the ColumnStore) plus the rewritten
    plan; callers hand both to the ordinary engine/planner — downsampled
    chunks are ordinary chunks."""

    def __init__(self, column_store, dataset: str, num_shards: int,
                 resolutions: Sequence[int] = (300_000, 3_600_000),
                 schemas: Optional[Schemas] = None):
        self.store = column_store
        self.dataset = dataset
        self.num_shards = num_shards
        self.resolutions = tuple(sorted(resolutions))
        self.schemas = schemas or DEFAULT_SCHEMAS
        self._shards: Dict[int, List[TimeSeriesShard]] = {}

    def shards_for_resolution(self, res: int) -> List[TimeSeriesShard]:
        got = self._shards.get(res)
        if got is None:
            name = ds_dataset(self.dataset, res)
            got = []
            for sh in range(self.num_shards):
                shard = TimeSeriesShard(DatasetRef(name), self.schemas, sh,
                                        column_store=self.store)
                shard.bootstrap_from_store()
                got.append(shard)
            self._shards[res] = got
        return got

    def plan_query(self, plan, window_ms: int, step_ms: int
                   ) -> Optional[Tuple[List[TimeSeriesShard], object]]:
        """(shards, rewritten_plan) when a downsample resolution can serve
        this query, else None (caller uses the raw store)."""
        res = select_resolution(self.resolutions, window_ms, step_ms)
        if res is None:
            return None
        rewritten = rewrite_plan(plan, res)
        if rewritten is None:
            return None     # function has no exact ds mapping: use raw
        return self.shards_for_resolution(res), rewritten
