"""Canonical lock-acquisition order for the threaded subsystems.

The interprocedural engine derives the *observed* acquisition-order
graph (``CallGraph.order_pairs``); cycles in it are potential deadlocks
(``lock-order-cycle``) regardless of this table. The table adds a
*declared* order for the known hot locks: acquiring a lock that sits
EARLIER in the list while holding a later one is a
``lock-order-policy`` finding even before a second thread closes the
cycle — the policy keeps the order consistent so cycles cannot form as
the call graph grows.

The order is coordinator-out-to-leaf (coarse, long-lived coordination
locks first; fine, short-hold data locks last). A lock not listed here
is unconstrained relative to the table (cycle detection still covers
it). Lock names are the engine's canonical form: ``Cls.attr`` for
instance locks (one order node per class — the standard abstraction),
``pkg.mod:name`` for module globals.

When real code needs a new nesting, EXTEND the table (and think about
which side every existing pair lands on) rather than pragma-ing the
finding: the table is the documentation of record for "which lock may
I take while holding which".
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# outermost (acquired first) .. innermost (acquired last, leaf)
CANONICAL_LOCK_ORDER: Tuple[str, ...] = (
    # host-level coordination: the worker supervisor's fleet state
    # (its methods never call into a worker's in-process locks — the
    # supervisor talks to workers over HTTP/bus only — but keep it
    # outermost so that invariant is policy, not accident)
    "Supervisor._lock",
    # node-level coordination: membership/handoff + crash reassignment
    "MembershipManager._lock",
    "FiloServer._reassign_lock",
    # serving-path subsystem locks
    "MicroBatcher._lock",
    "BreakerRegistry._lock",
    "PlanCache._lock",
    "ResultCache._lock",
    # memstore / device-store data locks
    "TorchBackend._exec_lock",
    "TorchBackend._tile_lock",
    "TimeSeriesShard._odp_lock",
    "TimeSeriesPartition._cache_lock",
    # tenant QoS (query/qos.py): the admission controller's gate
    # counters sit above the budget map, which sits above individual
    # bucket leaves (TenantBudgets.bucket() creates under the map lock;
    # snapshot() reads bucket counters while iterating the map)
    "AdmissionController._lock",
    "TenantBudgets._lock",
    "TokenBucket._lock",
    # leaves: short-hold counters, per-object state, channel caches
    "ShardMapper._lock",
    "CircuitBreaker._lock",
    "BatchStats._lock",
    "SplitResult._lock",
    # rules engine (filodb_tpu_torch/rules): scheduler/election/alert state.
    # Evaluations and write-backs run strictly OUTSIDE it; while held
    # it only touches registry family leaves (below), so it sits above
    # the observability leaves and below every serving-path lock.
    "RulesEngine._lock",
    "WebhookNotifier._lock",
    # observability leaves: the self-monitor's tick counters, the
    # device profiler's executable table (compiles run OUTSIDE it),
    # and the metric registry's family maps (collect_into snapshots
    # under the lock, samples outside)
    "SelfMonitor._lock",
    "DeviceProfiler._lock",
    # the wall-clock sampling profiler's folded-stack tables and the
    # trace exporter's bounded queue: both export through registry
    # family leaves (below) and never call back up the stack
    "SamplingProfiler._lock",
    "TraceExporter._lock",
    "MetricsRegistry._lock",
    "CounterFamily._lock",
    "GaugeFamily._lock",
    "GrpcQueryServer._rpc_lock",
    "LogIngestionStream._lock",
    "MemoryIngestionStream._lock",
    "filodb_tpu_torch.grpcsvc.client:_channels_lock",
    # control-plane bus (standalone/bus.py): registry locks release
    # before any socket send; per-connection send locks are pure leaves
    "SupervisorBus._lock",
    "BusClient._lock",
    "BusClient._send_lock",
)

_INDEX: Dict[str, int] = {name: i
                          for i, name in enumerate(CANONICAL_LOCK_ORDER)}


def policy_violation(held: str, acquired: str) -> Optional[str]:
    """Non-None (the message core) when acquiring ``acquired`` while
    holding ``held`` contradicts the canonical order. Pairs with a lock
    outside the table are unconstrained."""
    hi, ai = _INDEX.get(held), _INDEX.get(acquired)
    if hi is None or ai is None or ai > hi:
        return None
    return (f"acquires {acquired} (order #{ai}) while holding {held} "
            f"(order #{hi}) — canonical order is outermost-first; see "
            f"filodb_tpu_torch/lint/lockorder.py")
