"""Tenant QoS and brownout control: cost-based admission, per-tenant
token-bucket budgets, and priority classes for the micro-batcher (the
counterpart of ``filodb_tpu.query.qos``; the port serves one node, so
no fan-out leg reaches ``charge_forced`` yet).

The reference keeps one noisy tenant from taking down shared serving
with per-tenant guardrails (the ``ratelimit`` cardinality quota tree,
per-query sample limits). This module is the end-to-end overload story
those pieces were missing:

* **Cost estimation before execution** — :func:`estimate_plan_cost`
  prices a parsed plan from its SHAPE (node count, window/step ratio),
  the evaluation grid's step count, and the shard-key cardinality the
  per-shard :class:`~filodb_tpu_torch.core.cardinality.CardinalityTracker`
  prefix tree / tag-index postings record for the plan's leaf filters.
  The estimate need not be right in absolute terms; it must be
  MONOTONE — a strictly heavier query must never price below a lighter
  one.

* **Per-tenant token buckets** — :class:`TenantBudgets` charges each
  admitted query's estimated cost against its tenant's
  :class:`TokenBucket` (tenant = ``X-Filo-Tenant`` header / ``&tenant=``
  param, ``default`` otherwise; by convention the workspace ``_ws_``).
  An over-budget tenant is throttled SELECTIVELY — other tenants'
  queries sail through untouched — and fan-out legs (gRPC Exec, raw
  leaf dispatch, ``dispatch=local`` pushdown) inherit the charge via
  :meth:`TenantBudgets.charge_forced`, so a query's cluster-wide cost
  lands on its tenant no matter where the work runs.

* **Admission control with a bounded wait** — :class:`AdmissionController`
  replaces the HTTP edge's blind ``BoundedSemaphore``: slot waits are
  BOUNDED (``wait_s``), and saturation maps to HTTP 429 +
  ``Retry-After`` (:class:`AdmissionRejected`) instead of a silent hang
  until the client's own timeout — distinct from the 503 deadline path.

* **Priority classes** — interactive (0) > rules/background (1) >
  over-budget best-effort (2). The active class rides a thread-local
  :class:`QosContext` (captured across the device-executor hop like the
  trace context) so the micro-batcher can order its dispatch queue by
  class: a brownout's monster scans never head-of-line block cheap
  interactive queries.

Budgets default OFF (``default_rate == 0`` and no overrides): every
path then short-circuits to the pre-QoS behavior, so a deployment that
never sets a budget knob is byte-identical to the old edge.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace


DEFAULT_TENANT = "default"
TENANT_HEADER = "X-Filo-Tenant"
PRIORITY_HEADER = "X-Filo-Priority"

# reserved internal tenants: self-telemetry (obs/selfmon.py) and the
# recording-rules engine (filodb_tpu_torch/rules) run at the BACKGROUND
# priority class and charge FORCED like fan-out legs — standing
# background evaluation must never bounce off a drained admission
# bucket, and must never crowd out interactive user queries. Not a
# bypass a user should borrow: forced charges still land on the
# tenant's bucket (driving it into debt), they just never shed.
SELFMON_TENANT = "__selfmon__"
RULES_TENANT = "__rules__"
INTERNAL_TENANTS = frozenset({SELFMON_TENANT, RULES_TENANT})

# priority classes, lower = sooner. Interactive is the default for
# client traffic; rules/background is for standing evaluation and
# maintenance work; best-effort is what an over-budget tenant's
# degraded queries run at.
PRIORITY_INTERACTIVE = 0
PRIORITY_BACKGROUND = 1
PRIORITY_BEST_EFFORT = 2
PRIORITY_NAMES = {PRIORITY_INTERACTIVE: "interactive",
                  PRIORITY_BACKGROUND: "background",
                  PRIORITY_BEST_EFFORT: "best_effort"}
_PRIORITY_BY_NAME = {
    "interactive": PRIORITY_INTERACTIVE,
    "background": PRIORITY_BACKGROUND,
    "rules": PRIORITY_BACKGROUND,
    "best_effort": PRIORITY_BEST_EFFORT,
    "best-effort": PRIORITY_BEST_EFFORT,
}


def parse_priority(raw: Optional[str]) -> int:
    """Priority class from a header/param value; unknown/absent values
    are interactive (never reject a query over a bad priority hint)."""
    if not raw:
        return PRIORITY_INTERACTIVE
    return _PRIORITY_BY_NAME.get(str(raw).strip().lower(),
                                 PRIORITY_INTERACTIVE)


@dataclass
class QosContext:
    """Per-query QoS state riding a thread-local (and hopping threads
    with the batcher closure, like the trace context)."""
    tenant: str = DEFAULT_TENANT
    priority: int = PRIORITY_INTERACTIVE
    # True once the query entered the degrade ladder (over budget /
    # host saturated): executions run best-effort and responses carry
    # the shed warning
    degraded: bool = False
    # True on fan-out legs (gRPC Exec / raw leaf / dispatch=local):
    # the entry node already made the admission decision — legs charge
    # forced and never shed
    forced: bool = False


_state = threading.local()


def current() -> Optional[QosContext]:
    """The thread's active QoS context (None outside a query)."""
    return getattr(_state, "ctx", None)


def current_priority() -> int:
    ctx = current()
    return ctx.priority if ctx is not None else PRIORITY_INTERACTIVE


def capture() -> Optional[QosContext]:
    """Snapshot for cross-thread hops (the batcher's executor closure
    re-installs it with :func:`use`)."""
    return current()


@contextmanager
def activate(ctx: Optional[QosContext]):
    """Install ``ctx`` as the thread's QoS context for the duration."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


# `use` mirrors obs_trace.use: same name, same re-install semantics
use = activate


# ---------------------------------------------------------------------------
# cost estimation
# ---------------------------------------------------------------------------

@dataclass
class QueryCost:
    """One plan's pre-execution price breakdown. ``total`` is the unit
    charged against the tenant bucket; the parts ride trace tags and
    the slow-query log so an operator can see WHY a query priced high."""
    series: int = 1
    steps: int = 1
    window_factor: float = 1.0
    shape_weight: float = 1.0
    total: float = 1.0


# fallback guess when no cardinality source can price a leaf (cold
# tracker, pure remote dispatch with no metering view): assume a
# mid-size selector rather than 0 — underpricing unknown work is how a
# noisy tenant sneaks past the bucket
_UNKNOWN_SERIES_GUESS = 64


def _leaf_series_estimate(filters: Sequence[object],
                          shards: Sequence[object],
                          metering: Optional[object] = None) -> int:
    """Series-count estimate for one RawSeries leaf: the cardinality
    tracker's count at the longest concrete shard-key prefix the
    filters pin, refined (min) by the tag-index posting upper bound,
    summed over local shards. Remote shard groups carry no tracker —
    the tenant-metering snapshot (cross-shard per-(ws, ns) counts)
    prices them when it knows the prefix."""
    from filodb_tpu_torch.core.cardinality import SHARD_KEY_LABELS
    eq = {f.label: str(f.value) for f in filters
          if getattr(f, "op", "") == "eq"}
    prefix: List[str] = []
    for lbl in SHARD_KEY_LABELS:
        if lbl in eq:
            prefix.append(eq[lbl])
        else:
            break
    # extra equality filters beyond the shard key (instance=..., ...)
    # narrow the match set; damp the estimate per filter. The damping
    # is uniform, so it cannot reorder two shapes that differ only in
    # breadth (the monotonicity contract).
    extra_eq = sum(1 for lbl in eq if lbl not in SHARD_KEY_LABELS)
    total = 0
    found = False
    remote = 0
    for s in shards:
        tracker = getattr(s, "card_tracker", None)
        if tracker is None:
            if hasattr(s, "fetch_raw"):
                remote += 1
            continue
        n = tracker.series_count(prefix)
        if n is None:
            continue
        idx = getattr(s, "index", None)
        if idx is not None and hasattr(idx, "posting_upper_bound"):
            ub = idx.posting_upper_bound(filters)
            if ub is not None:
                n = min(n, ub)
        total += n
        found = True
    if remote:
        # fan-out legs: the gossip-fed metering snapshot prices the
        # whole tenant prefix across the cluster when it can
        counted = None
        if metering is not None and prefix:
            counted = metering.count_for(tuple(prefix))
        if counted is not None:
            total += int(counted)
            found = True
        else:
            total += _UNKNOWN_SERIES_GUESS * remote
            found = True
    if not found:
        return _UNKNOWN_SERIES_GUESS
    return max(1, total >> (2 * extra_eq))


def estimate_plan_cost(plan, shards: Sequence[object],
                       metering: Optional[object] = None) -> QueryCost:
    """Pre-execution price of a parsed LogicalPlan over ``shards``.

    cost = series x steps x (1 + window/step) x shape_weight

    * series — cardinality-tracker / tag-index estimate per leaf
      selector (see :func:`_leaf_series_estimate`), summed over leaves;
    * steps — the evaluation grid's step count;
    * window/step — how many overlapping windows touch each sample
      (rate(x[5m]) at 10s steps re-reads each sample ~30x);
    * shape_weight — 1 + 0.15 per plan node (joins, aggregations,
      function applications each add passes over the grid).
    """
    from filodb_tpu_torch.query.planner import (plan_range, walk_leaf_filters,
                                          walk_plan_tree)
    rng = plan_range(plan)
    if rng is not None:
        start, step, end, window, _lookback = rng
        if step > 0:
            steps = (end - start) // step + 1
            window_factor = 1.0 + (float(window) / float(step)
                                   if window and window < (1 << 61)
                                   else 0.0)
        else:
            steps = 1
            window_factor = 1.0
    else:
        steps, window_factor = 1, 1.0
    nodes = [0]
    walk_plan_tree(plan, lambda p: nodes.__setitem__(0, nodes[0] + 1))
    shape_weight = 1.0 + 0.15 * max(0, nodes[0] - 1)
    leaves = walk_leaf_filters(plan)
    series = sum(_leaf_series_estimate(f, shards, metering)
                 for f in leaves) if leaves else 1
    total = max(1.0, float(series)) * max(1, int(steps)) \
        * window_factor * shape_weight
    return QueryCost(series=int(series), steps=int(steps),
                     window_factor=round(window_factor, 3),
                     shape_weight=round(shape_weight, 3),
                     total=float(total))


def estimate_leaf_cost(filters: Sequence[object],
                       shards: Sequence[object],
                       start_ms: int, end_ms: int) -> float:
    """Price of a raw leaf-dispatch read (no plan tree to walk):
    series estimate x span, with one cost unit per series-minute —
    the same order of magnitude a one-step-per-minute plan would
    charge, so leaf legs and whole-query hops price comparably."""
    series = _leaf_series_estimate(filters, shards)
    span_min = max(1.0, (int(end_ms) - int(start_ms)) / 60_000.0)
    return float(series) * span_min


# ---------------------------------------------------------------------------
# token buckets
# ---------------------------------------------------------------------------

class TokenBucket:
    """Cost-unit token bucket: refills at ``rate``/s up to ``burst``.

    ``try_charge`` is the admission check (atomic check-and-debit: no
    lost or double charges under concurrent callers — pinned by the
    concurrent-accounting test). ``charge_forced`` debits
    unconditionally — fan-out legs inherit the entry node's admission
    decision — and may drive the balance negative, throttling the
    tenant's NEXT queries; debt is floored at ``-3 x burst`` so one
    mispriced monster cannot lock a tenant out for unbounded time.

    A query priced above ``burst`` can never charge cleanly: it is
    permanently a degrade-ladder query for this tenant. That is the
    documented meaning of burst — the largest clean-admission query."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, 10.0 * rate)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last_s = clock()
        self.charged_total = 0.0
        self.admitted = 0
        self.throttled = 0
        self.forced_charges = 0

    def _refill(self) -> None:
        """Advance the bucket to now. MUST be called with ``_lock``
        held (every public method does; the accesses below are inside
        the callers' critical sections)."""
        now = self._clock()
        dt = now - self._last_s
        if dt > 0:
            self._tokens = min(self.burst,
                               self._tokens + dt * self.rate)
            self._last_s = now

    def try_charge(self, cost: float) -> bool:
        with self._lock:
            self._refill()
            if cost <= self._tokens:
                self._tokens -= cost
                self.charged_total += cost
                self.admitted += 1
                return True
            self.throttled += 1
            return False

    def note_throttled(self) -> None:
        """Count a throttle decided WITHOUT pricing (the drained-bucket
        fast path skips the plan walk entirely)."""
        with self._lock:
            self.throttled += 1

    def charge_forced(self, cost: float) -> None:
        with self._lock:
            self._refill()
            self._tokens = max(-3.0 * self.burst, self._tokens - cost)
            self.charged_total += cost
            self.forced_charges += 1

    def refund(self, cost: float) -> None:
        with self._lock:
            self._refill()
            self._tokens = min(self.burst, self._tokens + cost)

    def retry_after_s(self, cost: float) -> float:
        """Seconds until ``cost`` (capped at burst) could charge."""
        with self._lock:
            self._refill()
            needed = min(float(cost), self.burst) - self._tokens
        if needed <= 0:
            return 0.0
        if self.rate <= 0:
            return 60.0
        return needed / self.rate

    def remaining(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            self._refill()
            return {"remaining": round(self._tokens, 3),
                    "rate": self.rate, "burst": self.burst,
                    "charged_total": round(self.charged_total, 3),
                    "admitted": self.admitted,
                    "throttled": self.throttled,
                    "forced_charges": self.forced_charges}


class TenantBudgets:
    """Tenant -> :class:`TokenBucket`, created lazily from the default
    rate/burst or a per-tenant override.

    ``enabled`` is False when no budget is configured anywhere — every
    charge path then short-circuits (the pre-QoS behavior). Lock
    order: ``TenantBudgets._lock`` (map) strictly outside
    ``TokenBucket._lock`` (per-bucket counters)."""

    def __init__(self, default_rate: float = 0.0,
                 default_burst: float = 0.0,
                 overrides: Optional[Dict[str, object]] = None,
                 clock=time.monotonic):
        self.default_rate = float(default_rate or 0.0)
        self.default_burst = float(default_burst or 0.0)
        # tenant -> rate | [rate, burst]
        self.overrides = dict(overrides or {})
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        # degrade-ladder outcomes by rung name (stale/downsample/
        # partial) + hard rejections, across all tenants per tenant
        self.degraded: Dict[Tuple[str, str], int] = {}
        self.rejected: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.default_rate > 0 or bool(self.overrides)

    def _rate_burst(self, tenant: str) -> Tuple[float, float]:
        ov = self.overrides.get(tenant)
        if ov is None:
            return self.default_rate, self.default_burst
        if isinstance(ov, (list, tuple)):
            rate = float(ov[0])
            burst = float(ov[1]) if len(ov) > 1 else 0.0
            return rate, burst
        return float(ov), 0.0

    def bucket(self, tenant: str) -> Optional[TokenBucket]:
        """The tenant's bucket, or None when it is unbudgeted (rate 0
        and no override — unlimited)."""
        if not self.enabled:
            return None
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = self._rate_burst(tenant)
                if rate <= 0:
                    return None         # explicitly unlimited tenant
                b = TokenBucket(rate, burst, clock=self._clock)
                self._buckets[tenant] = b
        return b

    def try_charge(self, tenant: str, cost: float) -> bool:
        b = self.bucket(tenant)
        if b is None:
            return True
        return b.try_charge(cost)

    def charge_forced(self, tenant: str, cost: float) -> None:
        b = self.bucket(tenant)
        if b is not None:
            b.charge_forced(cost)

    def retry_after_s(self, tenant: str, cost: float) -> float:
        b = self.bucket(tenant)
        if b is None:
            return 0.0
        return b.retry_after_s(cost)

    def refund(self, tenant: str, cost: float) -> None:
        """Return a charge whose work never happened (a degrade-ladder
        rung that failed mid-execution): the tenant must not pay for an
        answer it never received."""
        b = self.bucket(tenant)
        if b is not None:
            b.refund(cost)

    def record_degraded(self, tenant: str, rung: str) -> None:
        with self._lock:
            k = (tenant, rung)
            self.degraded[k] = self.degraded.get(k, 0) + 1

    def record_rejected(self, tenant: str) -> None:
        with self._lock:
            self.rejected[tenant] = self.rejected.get(tenant, 0) + 1

    def snapshot(self) -> Dict[str, Dict]:
        """Per-tenant budget state for /metrics (bucket counters +
        degrade/reject outcomes)."""
        with self._lock:
            buckets = dict(self._buckets)
            degraded = dict(self.degraded)
            rejected = dict(self.rejected)
        out: Dict[str, Dict] = {}
        for tenant, b in buckets.items():
            out[tenant] = b.snapshot()
        for (tenant, rung), n in degraded.items():
            out.setdefault(tenant, {}).setdefault(
                "degraded", {})[rung] = n
        for tenant, n in rejected.items():
            out.setdefault(tenant, {})["rejected"] = n
        return out


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class AdmissionRejected(Exception):
    """Admission said no and no degraded answer exists: HTTP 429 with
    ``Retry-After`` (never the 503 deadline shape — a rejected query
    was never executed).

    ``retry_after_s=None`` means NO amount of waiting can help (a
    never-admittable query: its cost exceeds the tenant's burst at
    every degraded resolution) — the edge then omits the Retry-After
    header instead of emitting a misleading ``Retry-After: 1``, and
    the detail string says what would actually admit."""

    def __init__(self, detail: str,
                 retry_after_s: Optional[float] = 1.0,
                 tenant: str = DEFAULT_TENANT, reason: str = ""):
        super().__init__(detail)
        self.retry_after_s = None if retry_after_s is None \
            else max(0.0, float(retry_after_s))
        self.tenant = tenant
        self.reason = reason or "throttled"


_AWAIT_HELP = ("Wall seconds an admitted query waited for its admission "
               "slot (timeouts count in "
               "filodb_admission_wait_timeouts_total)")


class AdmissionController:
    """The HTTP edge's query gate, tenant-aware.

    Host concurrency stays a global bound (``max_inflight`` slots; a
    supervisor deployment splits the host total across workers exactly
    like before), but the wait is BOUNDED: a query that cannot get a
    slot within ``wait_s`` raises :class:`AdmissionRejected` (429 +
    Retry-After) instead of hanging on the semaphore until the client's
    own timeout. Per-tenant budget decisions live in ``budgets``; the
    HTTP layer runs the degrade ladder between the two.

    ``filodb_admission_wait_seconds`` (the global registry's, in every
    ``/metrics`` from the controller's construction on) holds how long
    each admitted query waited for its slot."""

    def __init__(self, max_inflight: int = 0, wait_s: float = 5.0,
                 budgets: Optional[TenantBudgets] = None):
        self.max_inflight = max(0, int(max_inflight or 0))
        self.wait_s = float(wait_s)
        self.budgets = budgets if budgets is not None else TenantBudgets()
        self._sem = threading.BoundedSemaphore(self.max_inflight) \
            if self.max_inflight else None
        self._lock = threading.Lock()
        self.inflight = 0
        self.wait_timeouts = 0
        self.slot_rejections = 0
        obs_metrics.GLOBAL_REGISTRY.histogram(
            "filodb_admission_wait_seconds", _AWAIT_HELP)

    @property
    def gated(self) -> bool:
        return self._sem is not None

    def try_acquire(self, wait_s: Optional[float] = None) -> bool:
        """Bounded slot acquire; True when admitted (or ungated)."""
        if self._sem is None:
            return True
        t0 = time.perf_counter()
        ok = self._sem.acquire(timeout=self.wait_s
                               if wait_s is None else float(wait_s))
        if ok:
            obs_metrics.observe("filodb_admission_wait_seconds",
                                _AWAIT_HELP, time.perf_counter() - t0)
            with self._lock:
                self.inflight += 1
        else:
            with self._lock:
                self.wait_timeouts += 1
        return ok

    def release(self) -> None:
        if self._sem is None:
            return
        with self._lock:
            self.inflight -= 1
        self._sem.release()

    @contextmanager
    def slot(self, tenant: str = DEFAULT_TENANT):
        """Bounded-wait admission slot; raises AdmissionRejected on
        saturation (the caller may still serve the stale-cache rung —
        that path reads memory, not a slot). The wait is the traced
        request's ``admission-wait`` span: ``inflight`` the slots held
        when it asked, ``outcome`` admitted or timeout."""
        with obs_trace.span("admission-wait",
                            inflight=self.inflight) as sp:
            ok = self.try_acquire()
            sp.tag(outcome="admitted" if ok else "timeout")
        if not ok:
            with self._lock:
                self.slot_rejections += 1
            raise AdmissionRejected(
                f"host saturated: no admission slot freed within "
                f"{self.wait_s:.1f}s", retry_after_s=self.wait_s,
                tenant=tenant, reason="saturated")
        try:
            yield self
        finally:
            self.release()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"max_inflight": self.max_inflight,
                    "inflight": self.inflight,
                    "wait_s": self.wait_s,
                    "wait_timeouts": self.wait_timeouts,
                    "slot_rejections": self.slot_rejections}


# what a stale-cache serve charges per served matrix cell, relative to
# the ~1 cost unit a computed step cell prices at: no selection, no
# decode, no device eval — just encode. Without this the stale rung
# would be free and an over-budget tenant could hammer it into a
# GIL-load vector; with it, the budget bounds TOTAL work done for the
# tenant, degraded serving included.
STALE_COST_FACTOR = 0.1


def stale_serve_cost(num_series: int, num_steps: int) -> float:
    return STALE_COST_FACTOR * max(1, num_series) * max(1, num_steps)


def coarsen_step_s(start_s: int, step_s: int, end_s: int,
                   max_steps: int) -> int:
    """Brownout rung: the smallest power-of-two multiple of ``step_s``
    that brings the grid to at most ``max_steps`` evaluation steps.
    Power-of-two multiples keep the bucketed executable-shape set tiny
    (the same reasoning as the results cache's pow2 span widening).
    Returns ``step_s`` unchanged when the grid is already small."""
    if step_s <= 0 or max_steps <= 0:
        return step_s
    n = (end_s - start_s) // step_s + 1
    mult = 1
    while n > max_steps:
        mult <<= 1
        n = (end_s - start_s) // (step_s * mult) + 1
    return step_s * mult
