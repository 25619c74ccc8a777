"""LogicalPlan AST (query/src/main/scala/filodb/query/LogicalPlan.scala:8).

Plans are built by the PromQL parser (filodb_tpu_torch.promql) and materialized by
planners (filodb_tpu_torch.query.planner) into executable plans.  Time fields are
milliseconds throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

from filodb_tpu_torch.core.index import ColumnFilter


@dataclass(frozen=True)
class RawSeriesPlan:
    """Select raw chunks/samples for series matching filters
    (LogicalPlan.scala:111 RawSeries)."""
    filters: Tuple[ColumnFilter, ...]
    start_ms: int          # data fetch range (already includes lookback)
    end_ms: int
    column: Optional[str] = None   # explicit value column (::col suffix)
    offset_ms: int = 0


@dataclass(frozen=True)
class PeriodicSeries:
    """Instant-vector selector evaluated on a step grid with lookback
    (LogicalPlan.scala:254)."""
    raw: RawSeriesPlan
    start_ms: int
    step_ms: int
    end_ms: int
    lookback_ms: int = 300_000   # Prometheus default staleness lookback
    offset_ms: int = 0
    at_ms: Optional[int] = None


@dataclass(frozen=True)
class PeriodicSeriesWithWindowing:
    """range-function(selector[window]) (LogicalPlan.scala:375)."""
    raw: RawSeriesPlan
    function: str                # range function name (rangefn registry key)
    window_ms: int
    start_ms: int
    step_ms: int
    end_ms: int
    func_args: Tuple[float, ...] = ()
    offset_ms: int = 0
    at_ms: Optional[int] = None


@dataclass(frozen=True)
class SubqueryWithWindowing:
    """range-function(<expr>[w:s]) (LogicalPlan.scala:307)."""
    inner: "LogicalPlan"
    function: str
    window_ms: int
    sub_step_ms: int
    start_ms: int
    step_ms: int
    end_ms: int
    func_args: Tuple[float, ...] = ()
    offset_ms: int = 0
    # @-pinned evaluation time (LogicalPlan.scala:349): the subquery grid
    # ends at at_ms and every outer step carries the same pinned value
    at_ms: Optional[int] = None


@dataclass(frozen=True)
class TopLevelSubquery:
    """<expr>[w:s] as the outermost expression (LogicalPlan.scala:349)."""
    inner: "LogicalPlan"
    start_ms: int
    step_ms: int
    end_ms: int
    original_lookback_ms: int = 0
    offset_ms: int = 0


@dataclass(frozen=True)
class Aggregate:
    """sum/avg/min/max/count/topk/... by (labels) (LogicalPlan.scala:429)."""
    op: str
    inner: "LogicalPlan"
    params: Tuple = ()                      # k for topk, q for quantile, ...
    by: Tuple[str, ...] = ()
    without: Tuple[str, ...] = ()


@dataclass(frozen=True)
class BinaryJoin:
    """vector-vector binary operation (LogicalPlan.scala:453)."""
    lhs: "LogicalPlan"
    op: str
    rhs: "LogicalPlan"
    cardinality: str = "one-to-one"   # one-to-one | many-to-one | one-to-many
    on: Optional[Tuple[str, ...]] = None
    ignoring: Tuple[str, ...] = ()
    include: Tuple[str, ...] = ()     # group_left/right(include)
    return_bool: bool = False


@dataclass(frozen=True)
class ScalarVectorBinaryOperation:
    """scalar op vector / vector op scalar (LogicalPlan.scala)."""
    op: str
    scalar: "LogicalPlan"     # ScalarPlan
    vector: "LogicalPlan"
    scalar_is_lhs: bool
    return_bool: bool = False


@dataclass(frozen=True)
class ApplyInstantFunction:
    inner: "LogicalPlan"
    function: str
    func_args: Tuple["LogicalPlan", ...] = ()


@dataclass(frozen=True)
class ApplyMiscellaneousFunction:
    inner: "LogicalPlan"
    function: str            # label_replace | label_join | ...
    str_args: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ApplySortFunction:
    inner: "LogicalPlan"
    descending: bool = False


@dataclass(frozen=True)
class ApplyLimitFunction:
    inner: "LogicalPlan"
    limit: int = 0


@dataclass(frozen=True)
class ApplyAbsentFunction:
    inner: "LogicalPlan"
    filters: Tuple[ColumnFilter, ...]
    start_ms: int = 0
    step_ms: int = 0
    end_ms: int = 0


@dataclass(frozen=True)
class ScalarTimeBasedPlan:
    """time(), hour(), ... evaluated on the step grid (ScalarPlan family)."""
    function: str
    start_ms: int
    step_ms: int
    end_ms: int


@dataclass(frozen=True)
class ScalarFixedDoublePlan:
    value: float
    start_ms: int
    step_ms: int
    end_ms: int


@dataclass(frozen=True)
class ScalarVaryingDoublePlan:
    """scalar(vector-expr) (ScalarVaryingDoublePlan)."""
    inner: "LogicalPlan"
    function: str = "scalar"


@dataclass(frozen=True)
class ScalarBinaryOperation:
    op: str
    lhs: Union[float, "LogicalPlan"]
    rhs: Union[float, "LogicalPlan"]
    start_ms: int = 0
    step_ms: int = 0
    end_ms: int = 0


@dataclass(frozen=True)
class VectorPlan:
    """vector(scalar) (VectorPlan)."""
    scalar: "LogicalPlan"


# --- metadata plans (LogicalPlan.scala metadata section) -------------------

@dataclass(frozen=True)
class LabelValues:
    label: str
    filters: Tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class LabelNames:
    filters: Tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class SeriesKeysByFilters:
    filters: Tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class TsCardinalities:
    shard_key_prefix: Tuple[str, ...]
    num_groups: int = 2


LogicalPlan = Union[
    RawSeriesPlan, PeriodicSeries, PeriodicSeriesWithWindowing,
    SubqueryWithWindowing, TopLevelSubquery, Aggregate, BinaryJoin,
    ScalarVectorBinaryOperation, ApplyInstantFunction,
    ApplyMiscellaneousFunction, ApplySortFunction, ApplyLimitFunction,
    ApplyAbsentFunction, ScalarTimeBasedPlan, ScalarFixedDoublePlan,
    ScalarVaryingDoublePlan, ScalarBinaryOperation, VectorPlan,
    LabelValues, LabelNames, SeriesKeysByFilters, TsCardinalities,
]


def is_scalar_plan(plan) -> bool:
    return isinstance(plan, (ScalarTimeBasedPlan, ScalarFixedDoublePlan,
                             ScalarVaryingDoublePlan, ScalarBinaryOperation))


def is_metadata_plan(plan) -> bool:
    return isinstance(plan, (LabelValues, LabelNames, SeriesKeysByFilters,
                             TsCardinalities))
