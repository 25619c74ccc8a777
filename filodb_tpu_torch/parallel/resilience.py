"""Degraded-mode execution primitives for the distributed query path:
bounded retries, per-peer circuit breakers, and deadline budgets.

The reference stack gets these from Akka (remote dispatch timeouts,
DeathWatch-driven circuit breaking in ActorPlanDispatcher +
queryActorsCircuitBreaker config, filodb-defaults.conf) and from the
Prometheus-federation ecosystem's partial-response semantics (Thanos
`partial_response_strategy`, M3 fanout warnings). This module is the
TPU build's equivalent, threaded through RemoteShardGroup /
GrpcShardGroup leaf dispatch and PromQlRemoteExec / GrpcRemoteExec
pushdown:

  * ``RetryPolicy`` — bounded retries with exponential backoff and full
    jitter, deadline-aware (never sleeps past the budget).
  * ``CircuitBreaker`` — opens after N consecutive transport failures
    and stops dialing the peer entirely; a half-open probe after
    ``reset_timeout_s`` lets ONE call through, and its outcome closes or
    re-opens the breaker. Keyed per peer address in a
    ``BreakerRegistry`` owned by the server (breaker state must outlive
    a single query).
  * ``Deadline`` — a remaining-time budget created at the HTTP/gRPC
    entry point and threaded down the exec tree, so every remote hop
    uses ``min(flat_timeout, remaining)`` instead of a flat 60s, and
    exhausted budgets fail fast with a clean QueryError.

Error taxonomy: ``TransportError`` (peer unreachable / RPC transport
failure — retryable, counts against the breaker) vs a plain
``QueryError`` from the peer (application-level — NOT retryable: the
peer answered; retrying would repeat the same error)."""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query.model import QueryError


class TransportError(QueryError):
    """The peer could not be reached or the transport failed mid-call.
    Retryable; consecutive occurrences trip the peer's circuit breaker."""


class BreakerOpenError(QueryError):
    """The peer's circuit breaker is open: the call was not attempted."""


class DeadlineExceeded(QueryError):
    """The query's deadline budget ran out."""


class Deadline:
    """Monotonic remaining-time budget for one query.

    Created once at the entry point; every remote call clips its flat
    timeout to ``remaining()`` and checks ``expired`` before dialing, so
    a query never outlives its budget no matter how many hops retry."""

    def __init__(self, budget_s: float, clock: Callable[[], float]
                 = time.monotonic):
        self._clock = clock
        self.budget_s = float(budget_s)
        self._t_end = clock() + float(budget_s)

    @classmethod
    def after(cls, budget_s: float, clock: Callable[[], float]
              = time.monotonic) -> "Deadline":
        return cls(budget_s, clock)

    def remaining(self) -> float:
        return self._t_end - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "query") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"deadline of {self.budget_s:g}s exceeded during {what}")

    def clip(self, timeout_s: float) -> float:
        """Flat per-hop timeout clipped to the remaining budget; raises
        when the budget is already gone (never dial with <= 0)."""
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"deadline of {self.budget_s:g}s exceeded before "
                f"remote call")
        return min(float(timeout_s), rem)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + full jitter
    (the AWS-style decorrelated backoff; Akka's RestartFlow analogue).
    ``max_attempts`` counts the first try: 3 = 1 call + 2 retries."""
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5       # fraction of the delay randomized away

    def delay_s(self, attempt: int, rng: Callable[[], float]
                = random.random) -> float:
        """Backoff before retry #``attempt`` (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** (attempt - 1))
        return d * (1.0 - self.jitter * rng())


class CircuitBreaker:
    """Per-peer transport circuit breaker (CLOSED -> OPEN -> HALF_OPEN).

    CLOSED: calls flow; ``failure_threshold`` CONSECUTIVE transport
    failures open it. OPEN: ``allow()`` is False (no dials) until
    ``reset_timeout_s`` elapses, then exactly one caller wins the
    half-open probe slot. HALF_OPEN: the probe's success closes the
    breaker, its failure re-opens it for another full timeout."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True when a call may be attempted now. In OPEN state, the
        first caller past the reset timeout claims the half-open probe;
        others keep getting False until the probe resolves."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    return True
                return False
            return False            # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()


class BreakerRegistry:
    """Address-keyed breaker map. One registry per server process (the
    HTTP server owns it), shared across queries so breaker state
    persists; a module-level default serves directly-constructed
    exec nodes/tests."""

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        # per-peer call-policy counters surfaced in /metrics:
        # attempts (dials tried), retries (re-dials after transport
        # failure), exhaustions (gave up with retries spent), rejections
        # (not dialed: breaker open)
        self._retry_stats: Dict[str, Dict[str, int]] = {}

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(self.failure_threshold,
                                   self.reset_timeout_s)
                self._breakers[key] = b
            return b

    def record(self, key: str, counter: str, n: int = 1) -> None:
        with self._lock:
            st = self._retry_stats.setdefault(
                key, {"attempts": 0, "retries": 0, "exhaustions": 0,
                      "rejections": 0})
            st[counter] = st.get(counter, 0) + n

    def metrics_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-peer view for the /metrics exposition: breaker state +
        retry counters. Breaker state reads take each breaker's own
        lock AFTER the registry lock is released (fixed order, no
        nesting)."""
        with self._lock:
            breakers = dict(self._breakers)
            stats = {k: dict(v) for k, v in self._retry_stats.items()}
        out: Dict[str, Dict[str, object]] = {}
        for key in set(breakers) | set(stats):
            entry: Dict[str, object] = dict(stats.get(key, {}))
            b = breakers.get(key)
            if b is not None:
                entry["state"] = b.state
            out[key] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()
            self._retry_stats.clear()


DEFAULT_BREAKERS = BreakerRegistry()


@dataclass
class PeerResilience:
    """The per-server bundle threaded planner -> exec nodes: retry
    policy + the breaker registry remote calls consult."""
    retry: RetryPolicy
    breakers: BreakerRegistry

    @classmethod
    def default(cls) -> "PeerResilience":
        return cls(retry=RetryPolicy(), breakers=DEFAULT_BREAKERS)


def resilient_call(do_call: Callable[[float], object], *,
                   key: str, node_id: str,
                   timeout_s: float,
                   retry: Optional[RetryPolicy] = None,
                   breakers: Optional[BreakerRegistry] = None,
                   deadline: Optional[Deadline] = None,
                   sleep: Callable[[float], None] = time.sleep):
    """Run one remote hop under the full policy stack.

    ``do_call(timeout_s)`` performs the dial with the given per-attempt
    timeout and raises TransportError on transport failure. Breaker-open
    peers are not dialed at all; transport failures are retried within
    the deadline budget; peer application errors pass straight through
    (the peer answered — retrying repeats the same error)."""
    retry = retry or RetryPolicy()
    registry = breakers or DEFAULT_BREAKERS
    breaker = registry.get(key)
    if not breaker.allow():
        registry.record(key, "rejections")
        # tracing: a rejected dial is a point event on the trace — the
        # call never happened, so there is no duration to record
        obs_trace.event("breaker-rejected", peer=node_id, key=key)
        raise BreakerOpenError(
            f"peer {node_id} ({key}) circuit breaker is open")
    attempt = 0
    while True:
        attempt += 1
        registry.record(key, "attempts")
        if deadline is not None:
            deadline.check(f"call to peer {node_id}")
        t = deadline.clip(timeout_s) if deadline is not None \
            else float(timeout_s)
        try:
            # each attempt is its own span: a retried call shows up in
            # the trace as SIBLING spans, the failed ones tagged with
            # the transport error (span __exit__ records it)
            with obs_trace.span("peer-attempt", peer=node_id,
                                attempt=attempt, retry=attempt > 1):
                out = do_call(t)
        except TransportError:
            breaker.record_failure()
            if attempt >= retry.max_attempts or not breaker.allow():
                registry.record(key, "exhaustions")
                raise
            d = retry.delay_s(attempt)
            if deadline is not None:
                rem = deadline.remaining()
                if rem <= 0:
                    registry.record(key, "exhaustions")
                    raise
                d = min(d, max(rem - 1e-3, 0.0))
            registry.record(key, "retries")
            if d > 0:
                sleep(d)
            continue
        except QueryError:
            # the peer ANSWERED (transport is healthy): an application
            # error must not keep a half-open breaker stuck open, and
            # is never retried — the same call repeats the same error
            breaker.record_success()
            raise
        breaker.record_success()
        return out
