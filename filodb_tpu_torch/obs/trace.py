"""Lightweight distributed tracing for the serving pipeline.

Dapper-style propagated trace context: an entry node starts a trace
(sampled), every stage opens spans through the :func:`span` context
manager, and remote hops forward ``trace_id`` + the parent span id on
the wire (HTTP: the ``X-Filo-Trace`` header; gRPC: dedicated fields in
RawRequest/ExecRequest). The PEER records its spans locally and ships
them back in the response envelope, so the entry node's recorder holds
one stitched trace covering every hop — the standard tool for
attributing tail latency in a fan-out system.

Design constraints:

  * ~zero cost when no trace is active: ``span()`` reads one
    thread-local attribute and returns a shared no-op context manager.
    No allocation, no clock read, no string formatting happens on the
    untraced path — disabled-tracing responses stay byte-identical and
    the bench overhead stays within noise.
  * spans may be recorded from multiple threads (HTTP workers, the
    batcher's device-executor thread): the active trace is carried in a
    thread-local and can be captured/reinstalled across thread hops
    (:func:`capture` / :func:`use` — the micro-batcher does this for
    closures it runs on the executor thread).
  * bounded memory: a trace stops recording past ``MAX_SPANS`` (a
    runaway fan-out can't balloon the ring buffer), and the
    :class:`Tracer`'s recorder keeps the last N finished traces.
  * wall time and thread CPU time: a live span reads the wall clock
    (``time.time_ns()``, the clock the device trace is tied to) and the
    thread's CPU clock (``time.thread_time_ns()``) on enter and exit,
    so ``dur_us - cpu_us`` is the time its thread waited (for the
    interpreter lock, a lock, a device sync or a peer).
"""

from __future__ import annotations

import itertools
import json
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root


# spans per trace cap: a 256-shard fan-out with retries stays well under
# this; anything bigger is a runaway and gets truncated (tagged).
MAX_SPANS = 512

_ids = itertools.count(1)
_state = threading.local()


def _new_id() -> str:
    # 64-bit random hex; cheap, collision-safe at ring-buffer scale
    return f"{random.getrandbits(64):016x}"


class Span:
    """One timed operation inside a trace. Created via :func:`span`;
    mutate tags through ``tag()`` while open."""

    __slots__ = ("name", "span_id", "parent_id", "start_ns", "dur_ns",
                 "cpu_ns", "tags", "error")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str],
                 start_ns: int):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.dur_ns = -1            # -1 = still open
        self.cpu_ns = -1            # -1 = not measured (events)
        self.tags: Dict[str, object] = {}
        self.error: Optional[str] = None

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def to_json(self) -> Dict:
        d = {"name": self.name, "span_id": self.span_id,
             "parent_id": self.parent_id,
             "start_us": self.start_ns // 1000,
             "dur_us": self.dur_ns // 1000 if self.dur_ns >= 0 else -1}
        if self.cpu_ns >= 0:
            d["cpu_us"] = self.cpu_ns // 1000
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.error:
            d["error"] = self.error
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "Span":
        s = cls(d.get("name", "?"), d.get("span_id", "?"),
                d.get("parent_id"), int(d.get("start_us", 0)) * 1000)
        dur = int(d.get("dur_us", -1))
        s.dur_ns = dur * 1000 if dur >= 0 else -1
        if d.get("cpu_us") is not None:
            s.cpu_ns = int(d["cpu_us"]) * 1000
        s.tags = dict(d.get("tags") or {})
        s.error = d.get("error")
        return s


class Trace:
    """One trace being recorded on THIS node (entry node or a peer
    serving a propagated context). Span appends are lock-protected —
    HTTP workers and the device executor both record."""

    __slots__ = ("trace_id", "node", "spans", "truncated", "_lock",
                 "root_parent", "sampled", "retain_reason", "decided")

    def __init__(self, trace_id: Optional[str] = None,
                 node: str = "", root_parent: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = trace_id or _new_id()
        self.node = node
        # parent span id carried in from the caller (peer hop); local
        # root spans attach under it so the entry node stitches cleanly
        self.root_parent = root_parent
        self.spans: List[Span] = []
        self.truncated = False
        # tail sampling: a PENDING trace records spans exactly like a
        # sampled one, but only survives into the recorder if the
        # finish-time retention decision (error / shed / slow / coin)
        # keeps it. ``sampled=False`` marks "coin said drop unless the
        # outcome is interesting"; ``retain_reason`` is stamped by
        # Tracer.finish_request for /debug/traces readers.
        self.sampled = sampled
        self.retain_reason: Optional[str] = None
        # set by Tracer.finish_request: the retention decision is made
        # once; spans closing after it (an HTTP request's response
        # write) still append to this object, retained or not
        self.decided = False
        self._lock = threading.Lock()

    def add(self, sp: Span) -> None:
        with self._lock:
            if len(self.spans) >= MAX_SPANS:
                self.truncated = True
                return
            self.spans.append(sp)

    def absorb(self, spans_json: List[Dict]) -> None:
        """Fold a peer's serialized spans into this trace (the stitch).
        The peer already parented them under the span id we forwarded."""
        with self._lock:
            for d in spans_json:
                if len(self.spans) >= MAX_SPANS:
                    self.truncated = True
                    return
                self.spans.append(Span.from_json(d))

    def spans_json(self) -> List[Dict]:
        with self._lock:
            return [s.to_json() for s in self.spans]

    def to_json(self) -> Dict:
        """The trace as JSON; ``duration_us`` is the longest of its
        top-most closed spans (those whose parent is not recorded here:
        the root, or while the root is still open, its closed
        children)."""
        spans = self.spans_json()
        ids = {s["span_id"] for s in spans}
        dur = 0
        for s in spans:
            if s["parent_id"] not in ids:
                dur = max(dur, s["dur_us"])
        d = {"trace_id": self.trace_id, "node": self.node,
             "num_spans": len(spans), "duration_us": dur,
             "truncated": self.truncated, "spans": spans}
        if self.retain_reason is not None:
            d["retained"] = self.retain_reason
        return d


class _NoopSpan:
    """Shared do-nothing context manager: the untraced fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags):
        return self


_NOOP = _NoopSpan()


class _LiveSpan:
    """Context manager recording one span into the active trace."""

    __slots__ = ("_trace", "_span", "_prev", "_cpu0")

    def __init__(self, trace: Trace, name: str, parent_id: Optional[str],
                 tags: Dict):
        self._trace = trace
        sp = Span(name, _new_id(), parent_id, time.time_ns())
        if tags:
            sp.tags.update(tags)
        self._span = sp

    def __enter__(self) -> Span:
        self._prev = getattr(_state, "parent", None)
        _state.parent = self._span.span_id
        # read after the wall clock on entry and before it on exit, so
        # the CPU interval lies inside the wall one
        self._cpu0 = time.thread_time_ns()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        sp.cpu_ns = time.thread_time_ns() - self._cpu0
        sp.dur_ns = time.time_ns() - sp.start_ns
        if exc is not None and sp.error is None:
            sp.error = f"{type(exc).__name__}: {exc}"
        _state.parent = self._prev
        self._trace.add(sp)
        return False


# -- the thread-local active-trace API ---------------------------------------

def span(name: str, **tags):
    """Open a span under the thread's active trace; no-op (shared
    object, no allocation) when no trace is active. Usable from any
    layer without threading a tracer object through."""
    tr = getattr(_state, "trace", None)
    if tr is None:
        return _NOOP
    return _LiveSpan(tr, name, getattr(_state, "parent", None), tags)


def event(name: str, **tags) -> None:
    """Zero-duration span (a point annotation, e.g. a breaker
    rejection); no-op when no trace is active."""
    tr = getattr(_state, "trace", None)
    if tr is None:
        return
    sp = Span(name, _new_id(), getattr(_state, "parent", None),
              time.time_ns())
    sp.dur_ns = 0
    if tags:
        sp.tags.update(tags)
    tr.add(sp)


def trace_active() -> bool:
    return getattr(_state, "trace", None) is not None


def current_trace() -> Optional[Trace]:
    return getattr(_state, "trace", None)


def capture() -> Optional[Tuple[Trace, Optional[str]]]:
    """Snapshot (trace, parent span id) for reinstalling on another
    thread (the batcher's executor hop); None when untraced."""
    tr = getattr(_state, "trace", None)
    if tr is None:
        return None
    return tr, getattr(_state, "parent", None)


class use:
    """Reinstall a captured trace context on the current thread:
    ``with trace.use(ctx): ...``. ``ctx=None`` is a no-op (so callers
    can pass ``capture()``'s result through unconditionally)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[Tuple[Trace, Optional[str]]]):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is None:
            return self
        self._prev = (getattr(_state, "trace", None),
                      getattr(_state, "parent", None))
        _state.trace = self._ctx[0]
        _state.parent = self._ctx[1]
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            _state.trace, _state.parent = self._prev
        return False


class activate:
    """Install ``trace`` as the thread's active trace for the scope
    (the per-request entry point; :class:`Tracer` wraps this).
    Activating the trace that is already active keeps its open span as
    the parent: a query path that activates the trace its HTTP handler
    started nests under the handler's ``request`` span."""

    __slots__ = ("_trace", "_prev")

    def __init__(self, trace: Optional[Trace]):
        self._trace = trace

    def __enter__(self) -> Optional[Trace]:
        self._prev = (getattr(_state, "trace", None),
                      getattr(_state, "parent", None))
        if self._trace is None or self._trace is not self._prev[0]:
            _state.trace = self._trace
            _state.parent = self._trace.root_parent \
                if self._trace is not None else None
        return self._trace

    def __exit__(self, *exc):
        _state.trace, _state.parent = self._prev
        return False


# -- wire propagation --------------------------------------------------------

HEADER = "X-Filo-Trace"


def inject_header() -> Optional[str]:
    """``trace_id-parent_span_id-1`` for the active trace (the b3-style
    single header), or None when untraced."""
    tr = getattr(_state, "trace", None)
    if tr is None:
        return None
    parent = getattr(_state, "parent", None) or ""
    return f"{tr.trace_id}-{parent}-1"


def parse_context(value: Optional[str]
                  ) -> Optional[Tuple[str, Optional[str]]]:
    """Parse a propagated context into (trace_id, parent_span_id);
    None on absent/malformed input (malformed context must never fail
    a query)."""
    if not value:
        return None
    parts = str(value).split("-")
    if len(parts) < 1 or not parts[0]:
        return None
    parent = parts[1] if len(parts) > 1 and parts[1] else None
    return parts[0], parent


def spans_wire(trace: Optional[Trace]) -> bytes:
    """Serialized spans for a response envelope (gRPC field / HTTP
    JSON); empty when untraced."""
    if trace is None:
        return b""
    return json.dumps(trace.spans_json(),
                      separators=(",", ":")).encode()


def absorb_spans(spans) -> None:
    """Fold a peer's already-parsed span list (JSON-decoded dicts) into
    the active trace; no-op when untraced or empty."""
    tr = getattr(_state, "trace", None)
    if tr is None or not spans:
        return
    try:
        tr.absorb([d for d in spans if isinstance(d, dict)])
    except (TypeError, ValueError):
        pass


def absorb_wire(buf) -> None:
    """Fold a peer's serialized span list into the active trace;
    tolerant of garbage (a peer's malformed payload must never fail
    the query)."""
    tr = getattr(_state, "trace", None)
    if tr is None or not buf:
        return
    try:
        if isinstance(buf, (bytes, bytearray)):
            buf = buf.decode()
        spans = json.loads(buf)
        if isinstance(spans, list):
            tr.absorb([d for d in spans if isinstance(d, dict)])
    except (ValueError, UnicodeDecodeError):
        pass


# -- the per-server tracer ---------------------------------------------------

class Tracer:
    """Sampling policy + bounded recorder of finished traces.

    One per server process (the HTTP server owns it). ``enabled=False``
    (the default) never starts traces — ``span()`` stays on the no-op
    path everywhere. A propagated context from a caller is always
    honored (the entry node made the sampling decision).

    Sampling is TAIL-based: when tracing is enabled, EVERY fresh
    request records into a cheap pending :class:`Trace`; the sampling
    coin only decides whether an *uninteresting* outcome survives.
    :meth:`finish_request` runs the retention decision on outcome —
    errors, shed/degraded results, and latency above ``slow_ms`` are
    always retained (so slowlog entries always link a live trace), the
    rest keep the ``sample_rate`` coin — so the recorder holds the
    interesting tail instead of a random head. Retained traces are
    additionally handed to the optional ``exporter``."""

    def __init__(self, enabled: bool = False, sample_rate: float = 1.0,
                 max_traces: int = 256, node: str = "",
                 slow_ms: float = 0.0,
                 exporter: Optional["TraceExporter"] = None):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.node = node
        self.slow_ms = float(slow_ms)
        self.exporter = exporter
        self._lock = threading.Lock()
        self._max = max(1, int(max_traces))
        # trace_id -> Trace; insertion-ordered ring (oldest evicted)
        self._finished: "OrderedDict[str, Trace]" = OrderedDict()
        self.started = 0
        self.sampled_out = 0
        self.tail_dropped = 0
        # retention-reason counters (snapshot + /metrics)
        self.retained: Dict[str, int] = {
            "sampled": 0, "error": 0, "shed": 0, "slow": 0, "forced": 0}

    def start(self, ctx: Optional[Tuple[str, Optional[str]]] = None,
              force: bool = False) -> Optional[Trace]:
        """A Trace for this request, or None (untraced). ``ctx`` is a
        propagated (trace_id, parent_span_id) from the caller — always
        honored. Fresh requests always get a pending trace when tracing
        is enabled; the ``sample_rate`` coin is flipped HERE but only
        consulted at finish (tail sampling — see class docstring).
        ``force`` (the ``&explain=trace`` opt-in) bypasses both the
        enable flag and the sampler for one request."""
        if ctx is not None:
            self.started += 1
            return Trace(ctx[0], node=self.node, root_parent=ctx[1])
        if not force:
            if not self.enabled:
                return None
            if self.sample_rate < 1.0 \
                    and random.random() >= self.sample_rate:
                # coin says drop — but keep recording: an error/shed/
                # slow outcome at finish overrides the coin
                self.sampled_out += 1
                self.started += 1
                return Trace(node=self.node, sampled=False)
        self.started += 1
        return Trace(node=self.node)

    def finish_request(self, trace: Optional[Trace], *,
                       error: bool = False, shed: bool = False,
                       duration_ms: Optional[float] = None,
                       force: bool = False) -> bool:
        """The tail-retention decision for an entry-node request trace:
        record it iff the outcome is interesting (error / QoS shed /
        above ``slow_ms``) or the start-time coin already kept it (or
        ``force`` — the explain path). Returns True when retained, so
        the caller can link the trace id (slowlog, exemplars) only to
        traces that actually resolve in ``/debug/traces``. Made once per
        trace: a second call returns the first decision."""
        if trace is None:
            return False
        if trace.decided:
            return trace.retain_reason is not None
        trace.decided = True
        slow = (self.slow_ms > 0.0 and duration_ms is not None
                and duration_ms >= self.slow_ms)
        if error:
            reason = "error"
        elif shed:
            reason = "shed"
        elif slow:
            reason = "slow"
        elif force:
            reason = "forced"
        elif trace.sampled:
            reason = "sampled"
        else:
            with self._lock:
                self.tail_dropped += 1
            return False
        trace.retain_reason = reason
        with self._lock:
            self.retained[reason] = self.retained.get(reason, 0) + 1
        self.finish(trace)
        return True

    def finish(self, trace: Optional[Trace]) -> None:
        """Record a completed ENTRY-NODE trace in the ring buffer (peer
        hops ship their spans back instead of recording locally).
        Unconditional — callers wanting tail retention go through
        :meth:`finish_request`."""
        if trace is None:
            return
        with self._lock:
            self._finished[trace.trace_id] = trace
            self._finished.move_to_end(trace.trace_id)
            while len(self._finished) > self._max:
                self._finished.popitem(last=False)
        exp = self.exporter
        if exp is not None:
            exp.enqueue(trace)

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._finished.get(trace_id)

    def recent(self, limit: int = 50) -> List[Trace]:
        with self._lock:
            out = list(self._finished.values())
        return out[-max(1, int(limit)):][::-1]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            stored = len(self._finished)
            retained = dict(self.retained)
            tail_dropped = self.tail_dropped
        return {"enabled": int(self.enabled), "started": self.started,
                "sampled_out": self.sampled_out, "stored": stored,
                "tail_dropped": tail_dropped, "retained": retained}


# -- trace export ------------------------------------------------------------

def _otlp_attr(key: str, value) -> Dict:
    """One OTLP KeyValue. Everything non-numeric ships as a string —
    the sink side treats tags as opaque annotations anyway."""
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def _otlp_span(trace: Trace, d: Dict) -> Dict:
    """One serialized span (``Span.to_json`` form) as an OTLP/JSON
    span. Our ids are 64-bit hex: the 128-bit OTLP traceId is
    zero-padded, spanId ships as-is."""
    start_ns = int(d.get("start_us", 0)) * 1000
    dur_us = int(d.get("dur_us", -1))
    out = {
        "traceId": str(trace.trace_id).zfill(32),
        "spanId": str(d.get("span_id", "")).zfill(16),
        "name": str(d.get("name", "?")),
        "kind": 1,      # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(start_ns + max(0, dur_us) * 1000),
    }
    parent = d.get("parent_id")
    if parent:
        out["parentSpanId"] = str(parent).zfill(16)
    attrs = [_otlp_attr(k, v)
             for k, v in sorted((d.get("tags") or {}).items())]
    if d.get("cpu_us") is not None:
        attrs.append(_otlp_attr("filodb.cpu_us", int(d["cpu_us"])))
    if attrs:
        out["attributes"] = attrs
    if d.get("error"):
        out["status"] = {"code": 2, "message": str(d["error"])}
    return out


def otlp_payload(traces: List[Trace], service: str = "filodb-tpu"
                 ) -> Dict:
    """An OTLP/JSON ``ExportTraceServiceRequest``-shaped body for a
    batch of finished traces (one resourceSpans entry per node)."""
    by_node: "Dict[str, List[Trace]]" = {}
    for tr in traces:
        by_node.setdefault(tr.node or "", []).append(tr)
    resource_spans = []
    for node in sorted(by_node):
        spans = []
        for tr in by_node[node]:
            for d in tr.spans_json():
                spans.append(_otlp_span(tr, d))
        res_attrs = [_otlp_attr("service.name", service)]
        if node:
            res_attrs.append(_otlp_attr("filodb.node", node))
        resource_spans.append({
            "resource": {"attributes": res_attrs},
            "scopeSpans": [{"scope": {"name": "filodb_tpu_torch.obs.trace"},
                            "spans": spans}],
        })
    return {"resourceSpans": resource_spans}


def _http_post_json(url: str, body: bytes, timeout_s: float) -> int:
    """Default transport: POST the OTLP/JSON body; any transport-layer
    failure (or a 5xx from the sink) raises TransportError so
    ``resilient_call`` retries and the breaker counts it."""
    from filodb_tpu_torch.parallel.resilience import TransportError
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return int(resp.status)
    except urllib.error.HTTPError as e:
        if e.code >= 500:
            raise TransportError(f"trace sink {url}: HTTP {e.code}")
        return int(e.code)      # 4xx: the sink answered; don't retry
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise TransportError(f"trace sink {url}: {e}")


@guarded_by("_lock", "_queue", "enqueued", "dropped", "batches",
            "spans_exported", "failures")
class TraceExporter:
    """Bounded background OTLP/JSON trace exporter (a declared thread
    root).

    Retained traces are enqueued by :meth:`Tracer.finish` (drop-oldest
    past ``queue_max`` — export lag must never block or balloon the
    serving path) and a daemon thread flushes batches to the configured
    sink through :func:`resilient_call`, so the sink gets the full
    breaker + backoff + deadline stack and a dead sink costs one
    breaker probe per reset period instead of a hung serving node."""

    def __init__(self, url: str, *, batch_max: int = 64,
                 interval_s: float = 2.0, queue_max: int = 1024,
                 timeout_s: float = 5.0, service: str = "filodb-tpu",
                 transport: Optional[
                     Callable[[str, bytes, float], int]] = None,
                 breakers=None, retry=None):
        self.url = str(url)
        self.batch_max = max(1, int(batch_max))
        self.interval_s = max(0.05, float(interval_s))
        self.queue_max = max(1, int(queue_max))
        self.timeout_s = float(timeout_s)
        self.service = service
        self._transport = transport or _http_post_json
        self._breakers = breakers
        self._retry = retry
        self._lock = threading.Lock()
        self._queue: "deque[Trace]" = deque()
        self.enqueued = 0
        self.dropped = 0
        self.batches = 0
        self.spans_exported = 0
        self.failures = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counter families: the exporter only exists when an export URL
        # is configured, so registering here never perturbs a default
        # /metrics exposition
        from filodb_tpu_torch.obs import metrics as obs_metrics
        reg = obs_metrics.GLOBAL_REGISTRY
        self._m_batches = reg.counter(
            "filodb_trace_export_batches_total",
            "Trace batches successfully POSTed to the export sink")
        self._m_spans = reg.counter(
            "filodb_trace_export_spans_total",
            "Spans shipped to the trace export sink")
        self._m_dropped = reg.counter(
            "filodb_trace_export_dropped_total",
            "Retained traces dropped before export (queue saturation)")
        self._m_failures = reg.counter(
            "filodb_trace_export_failures_total",
            "Export batches abandoned after breaker/retry gave up")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TraceExporter":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="trace-exporter")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- producer side -----------------------------------------------------
    def enqueue(self, trace: Trace) -> None:
        """Hand a retained trace to the exporter; never blocks. Oldest
        queued traces are evicted (and counted) past ``queue_max``."""
        with self._lock:
            while len(self._queue) >= self.queue_max:
                self._queue.popleft()
                self.dropped += 1
                self._m_dropped.inc()
            self._queue.append(trace)
            self.enqueued += 1
            full = len(self._queue) >= self.batch_max
        if full:
            self._wake.set()

    # -- exporter loop -----------------------------------------------------
    @thread_root("trace-exporter")
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            try:
                self.flush()
            except Exception:   # noqa: BLE001 — export must not die
                pass
        try:
            self.flush()        # final drain on shutdown
        except Exception:       # noqa: BLE001
            pass

    def flush(self) -> int:
        """Drain the queue in ``batch_max`` bites; returns spans
        shipped. A batch that exhausts retries (or meets an open
        breaker) is dropped and counted — export is best-effort by
        contract."""
        from filodb_tpu_torch.parallel.resilience import (QueryError,
                                                    resilient_call)
        shipped = 0
        while True:
            with self._lock:
                if not self._queue:
                    return shipped
                batch = [self._queue.popleft()
                         for _ in range(min(self.batch_max,
                                            len(self._queue)))]
            body = json.dumps(otlp_payload(batch, self.service),
                              separators=(",", ":")).encode()
            nspans = sum(len(tr.spans) for tr in batch)
            try:
                resilient_call(
                    lambda t: self._transport(self.url, body, t),
                    key=f"trace-export:{self.url}",
                    node_id="trace-export",
                    timeout_s=self.timeout_s,
                    retry=self._retry, breakers=self._breakers)
            except QueryError:
                with self._lock:
                    self.failures += 1
                self._m_failures.inc()
                continue
            with self._lock:
                self.batches += 1
                self.spans_exported += nspans
            self._m_batches.inc()
            self._m_spans.inc(nspans)
            shipped += nspans

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"url": self.url, "queued": len(self._queue),
                    "enqueued": self.enqueued, "dropped": self.dropped,
                    "batches": self.batches,
                    "spans_exported": self.spans_exported,
                    "failures": self.failures, "running": self.running}
