"""Threaded HTTP server exposing the Prometheus API over the memstore (the
counterpart of ``filodb_tpu.http.server``).

Routes mirror the reference (http/PrometheusApiRoute.scala:48-129,
HealthRoute.scala, ClusterApiRoute.scala):

  GET/POST /promql/{dataset}/api/v1/query_range?query&start&end&step
  GET/POST /promql/{dataset}/api/v1/query?query&time
  GET      /promql/{dataset}/api/v1/labels
  GET      /promql/{dataset}/api/v1/label/{name}/values
  GET      /promql/{dataset}/api/v1/series?match[]=<selector>&start&end
  POST     /promql/{dataset}/api/v1/read   (Prometheus remote read)
  POST     /api/v1/ingest/influx            (with a gateway)
  GET      /__health | /__liveness | /__readiness
  GET      /api/v1/cluster/{dataset}/status
  GET      /api/v1/cardinality[-local]/{dataset}?prefix&depth
  POST     /api/v1/raw/{dataset}            (peer leaf fetch)
  POST     /admin/{drain,adopt,transfer,abort_adopt}
  GET      /api/v1/rules[?explain=analyze][&debug=1]
  GET      /api/v1/alerts
  GET      /metrics
  GET      /debug/queries | /debug/slow_queries | /debug/traces |
           /debug/events | /debug/profile | /debug/threads

Query endpoints pass the admission gate (bounded in-flight evaluations,
429 + Retry-After on saturation), the tenant QoS ladder, the plan cache
and the results cache before the planner and the engine.

The cluster plane (``peers``): ``POST /api/v1/raw/{dataset}`` serves
peers' leaf fetches over HTTP (the gRPC ``FetchRaw`` service shares its
selection, :meth:`FiloHttpServer.leaf_select`), ``/admin/{drain,adopt,
transfer,abort_adopt}`` is the planned-membership control plane, and
metadata and cardinality fan out to the live peers. The per-query deadline
(``&timeout=``, ``query-timeout-s``) and ``&allow_partial=`` act on the
remote paths, as in the reference.

A route whose feature is off by config answers as the reference does with
that feature off (rules and alerts without rules, influx ingest without a
gateway, ``/debug/profile`` without the sampling profiler). The reserved
``__rules__`` and ``__selfmon__`` datasets (recorded series and alert
state; self-ingested metrics) are planned over this process's internal
shard only.

Device observability, as in the reference: ``&explain=trace`` inlines the
query's trace; ``&explain=analyze`` adds the stage timings, the executables
the query's dispatches ran with their analytic cost (``obs/devprof.py``),
the batcher's occupancy, the QoS decision and the device residency.
``/debug/threads`` lists the ``@thread_root`` inventory and
``/debug/profile`` the sampling profiler's aggregate.

stdlib http.server (the JVM reference uses Akka-HTTP; the edge is not the
hot path — all bulk compute is device-side behind QueryEngine)."""

from __future__ import annotations

import functools
import json
import re
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.http import prom_json
from filodb_tpu_torch.lint import capacity as lint_capacity
from filodb_tpu_torch.lint.caches import publishes
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.ingest import health as ingest_health
from filodb_tpu_torch.obs import SELFMON_DATASET
from filodb_tpu_torch.obs import devprof as obs_devprof
from filodb_tpu_torch.obs import events as obs_events
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.obs.profiler import SamplingProfiler
from filodb_tpu_torch.obs.slowlog import InflightRegistry, SlowQueryLog
from filodb_tpu_torch.obs.trace import Tracer
from filodb_tpu_torch.parallel.resilience import (Deadline,
                                                  DeadlineExceeded,
                                                  PeerResilience)
from filodb_tpu_torch.promql.parser import (TimeStepParams, parse_query,
                                            parse_query_range,
                                            selector_to_filters)
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.query.engine import (SELECT_MEMO_HITS,
                                           SELECT_MEMO_MISSES, QueryEngine)
from filodb_tpu_torch.query.planner import QueryPlanner
from filodb_tpu_torch.query.model import (GridResult, QueryError,
                                          QueryLimitError, QueryLimits,
                                          ScalarResult, StaleRoutingError)

_ROUTE = re.compile(r"^/promql/(?P<ds>[^/]+)/api/v1/(?P<rest>.+)$")

# reserved internal datasets: strictly node-local planners, own cardinality
# accounting (__selfmon__ holds self-ingested telemetry; __rules__ holds
# recording-rule outputs)
INTERNAL_DATASETS = (SELFMON_DATASET, qos.RULES_TENANT)

_QLAT_HELP = ("End-to-end query latency in seconds at the HTTP edge "
              "(parse + plan + execute + encode)")


# promlint findings per query text: queries repeat (dashboards), the
# analysis is pure, and the hot path must not re-walk the AST per refresh
@functools.lru_cache(maxsize=512)
def _lint_memo(query: str, schema_items: Tuple) -> Tuple:
    from filodb_tpu_torch.promql import semant
    schemas = semant.MetricSchemas(dict(schema_items))
    return tuple(semant.lint_query(query, schemas))


class _Handled(Exception):
    """Control-flow: response (code, payload) already decided."""

    def __init__(self, code: int, payload):
        super().__init__(code)
        self.code = code
        self.payload = payload


class _FastHeaders(dict):
    """Case-insensitive header map for the fast request-parse path
    (keys stored lower-cased)."""

    def get(self, name, default=None):  # noqa: A003 — dict interface
        return dict.get(self, name.lower(), default)

    def __contains__(self, name):
        return dict.__contains__(self, str(name).lower())


class FiloHttpServer:
    """Serves one or more datasets; each maps to a list of shards."""

    def __init__(self, shards_by_dataset: Dict[str, list],
                 backend: Optional[object] = None,
                 shard_mapper: Optional[object] = None,
                 mesh_executor: Optional[object] = None,
                 spread: int = 1,   # MUST match ingest spread (default-spread)
                 host: str = "127.0.0.1", port: int = 0,
                 ds_store_by_dataset: Optional[Dict[str, object]] = None,
                 raw_retention_ms: int = 0,
                 query_limits: Optional[QueryLimits] = None,
                 spread_provider: Optional[object] = None,
                 node_id: Optional[str] = None,
                 peers: Optional[Dict[str, str]] = None,
                 buddies: Optional[Dict[str, str]] = None,
                 partitions: Optional[Dict[str, str]] = None,
                 local_partitions: Optional[List[str]] = None,
                 grpc_peers: Optional[Dict[str, str]] = None,
                 grpc_partitions: Optional[Dict[str, str]] = None,
                 query_timeout_s: float = 30.0,
                 resilience: Optional[PeerResilience] = None,
                 plan_cache_size: int = 256,
                 results_cache_mb: float = 64.0,
                 results_cache_hot_window_ms: float = 10_000.0,
                 max_inflight_queries: int = 4,
                 admission_wait_s: float = 5.0,
                 qos_budgets: Optional[qos.TenantBudgets] = None,
                 qos_degrade_max_steps: int = 64,
                 qos_shed_degraded: bool = True,
                 tracer: Optional[Tracer] = None,
                 slow_query_ms: float = 1000.0,
                 slow_query_capacity: int = 128,
                 peer_fanout_workers: int = 0,
                 worker_id: Optional[int] = None,
                 profiler: Optional[SamplingProfiler] = None):
        self.shards_by_dataset = shards_by_dataset
        self.backend = backend
        self.shard_mapper = shard_mapper
        # the scatter-gather mesh executor (parallel/mesh.py), None off
        self.mesh_executor = mesh_executor
        self.spread = spread
        # raw/downsample tiering: dataset -> DownsampledTimeSeriesStore,
        # and the raw retention past which the planner stitches it in
        self.ds_store_by_dataset = ds_store_by_dataset or {}
        self.raw_retention_ms = raw_retention_ms
        self.query_limits = query_limits
        self.spread_provider = spread_provider
        self.node_id = node_id
        # multi-process cluster plane (parallel/cluster.py): peer node_id
        # -> base URL for leaf dispatch and metadata fan-out; buddy
        # replicas, federated partitions and the gRPC data plane's
        # addresses (the failure detector fills grpc_peers from peers'
        # health bodies)
        self.peers = dict(peers or {})
        self.buddies = dict(buddies or {})
        self.partitions = dict(partitions or {})
        self.local_partitions = list(local_partitions or ())
        self.grpc_peers = dict(grpc_peers or {})
        self.grpc_partitions = dict(grpc_partitions or {})
        # downgrades of this node's gRPC calls to the HTTP JSON plane
        # (imported here: grpcsvc.wire imports the http package)
        from filodb_tpu_torch.grpcsvc.client import PlaneFallbacks
        self.plane_fallbacks = PlaneFallbacks()
        # set by the standalone server: the GrpcQueryServer (/metrics
        # gauge, health-body advertisement)
        self.grpc_server = None
        # degraded-mode execution: default per-query deadline budget +
        # the server-lifetime retry policy / breaker registry (breaker
        # state persists across queries by construction)
        self.query_timeout_s = float(query_timeout_s)
        if resilience is None:
            from filodb_tpu_torch.parallel.resilience import (
                BreakerRegistry, RetryPolicy)
            resilience = PeerResilience(RetryPolicy(), BreakerRegistry())
        self.resilience = resilience
        # set by the standalone server: FailureDetector whose down-view
        # rides the health body (quorum input for elastic reassignment)
        self.detector = None
        # set by the standalone server: MembershipManager behind the
        # /admin/{drain,adopt,transfer,abort_adopt} endpoints
        self.membership = None
        # elastic membership read-path state:
        #  * handoff_sources — shard -> previous-owner node for shards
        #    THIS node is adopting mid-handoff; the planner redirects
        #    reads there until the replay flips ACTIVE;
        #  * peer_watermarks — gossiped per-peer ingest watermarks /
        #    backfill epochs (FailureDetector peer_state_sink) stamped
        #    onto remote shard groups for results-cache freshness;
        #  * stale-routing counters for /metrics.
        self.handoff_sources: Dict[int, str] = {}
        self.peer_watermarks: Dict[str, Dict] = {}
        self.stale_routing_bounces = 0
        self.stale_routing_retries = 0
        # metadata/cardinality peer fan-out concurrency (0 = auto from
        # the host's core count)
        if peer_fanout_workers and int(peer_fanout_workers) > 0:
            self.fanout_workers = int(peer_fanout_workers)
        else:
            import os
            self.fanout_workers = min(32, max(2, os.cpu_count() or 2))
        # process-sharded serving: this worker's ordinal under the
        # supervisor (None outside one), exported as a gauge so a scrape
        # of the private port tells the workers apart; the BusClient of
        # its control plane is set by the standalone server
        self.worker_id = worker_id
        self.bus_client = None
        # the GatewayServer behind /api/v1/ingest/influx (the remote
        # ingest edge with an ack channel); None = no gateway here
        self.gateway = None
        # core/metering.TenantMetering: the /metrics tenant families and
        # the QoS cost of the planner; None = metering off
        self.tenant_metering = None
        # set by the standalone server under self-monitor: the SelfMonitor
        # loop (obs/selfmon.py) whose liveness gauges ride /metrics
        self.selfmon = None
        # set by the standalone server when rules are configured: the
        # RulesEngine (rules/engine.py) behind /api/v1/rules and
        # /api/v1/alerts; its evaluations call rule_eval_range below
        self.rules = None
        # observability: the tracer owns the sampling decision + the
        # bounded ring behind /debug/traces; the slow-query log and
        # in-flight registry serve /debug/slow_queries and
        # /debug/queries. Tracing defaults OFF — span() stays on its
        # no-op path and responses are byte-identical to the untraced
        # build.
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=False, node=node_id or "")
        self.slow_log = SlowQueryLog(threshold_ms=float(slow_query_ms),
                                     capacity=int(slow_query_capacity))
        self.inflight = InflightRegistry()
        # set by the standalone server under profiler-enabled (or injected
        # by tests): the wall-clock sampling profiler behind
        # /debug/profile. None (the default) keeps the endpoint a 404 and
        # the metrics surface untouched.
        self.profiler = profiler
        # admission control on the QUERY endpoints (query/qos.py): excess
        # requests park on the controller's semaphore, but the wait is
        # BOUNDED (admission_wait_s): saturation answers 429 +
        # Retry-After instead of hanging until the client's own timeout.
        # Per-tenant token-bucket budgets make the shed SELECTIVE.
        # Metadata, health and cluster endpoints bypass the gate.
        self.admission = qos.AdmissionController(
            max_inflight=max(1, int(max_inflight_queries))
            if max_inflight_queries else 0,
            wait_s=float(admission_wait_s),
            budgets=qos_budgets)
        # the selection memo's counters (query/engine.py), in /metrics
        # from the start rather than from the first selection
        for fam in (SELECT_MEMO_HITS, SELECT_MEMO_MISSES):
            obs_metrics.GLOBAL_REGISTRY.counter(*fam).inc(0)
        # brownout ladder knobs: coarsen rung targets at most this many
        # evaluation steps; False turns the whole ladder off (over-
        # budget goes straight to 429)
        self.qos_degrade_max_steps = int(qos_degrade_max_steps)
        self.qos_shed_degraded = bool(qos_shed_degraded)
        # serving fast path: parsed-plan LRU (start/end abstracted out of
        # the key; dashboards re-issuing the same text skip parse+plan).
        # Invalidation: shard-topology events from the mapper, plus the
        # explicit invalidate_plan_cache() hook for schema changes.
        from filodb_tpu_torch.query.plancache import PlanCache
        self.plan_cache = PlanCache(capacity=plan_cache_size)
        if shard_mapper is not None:
            shard_mapper.subscribe(
                lambda ev: self.plan_cache.invalidate("topology"))
        # incremental range-query results cache (query/resultcache.py):
        # per-step matrix extents keyed on the plan cache's range-
        # abstracted key + step alignment; topology/schema invalidation
        # rides the plan cache's listener hook; freshness is bounded by
        # shard ingest watermarks + the hot window.
        from filodb_tpu_torch.query.resultcache import ResultCache
        self.result_cache = ResultCache(
            max_bytes=int(float(results_cache_mb) * (1 << 20)),
            hot_window_ms=float(results_cache_hot_window_ms))
        self.plan_cache.add_invalidation_listener(
            self.result_cache.invalidate)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response carries Content-Length,
            # so pipelined handling is safe on the stdlib server
            protocol_version = "HTTP/1.1"
            # without TCP_NODELAY the stdlib server's small header
            # writes hit the Nagle + delayed-ACK interaction: every
            # response on a persistent connection stalls ~40ms
            disable_nagle_algorithm = True
            # buffer the response writes (one syscall per response, not
            # one per header); flushed per request by handle()
            wbufsize = 64 * 1024

            def log_message(self, fmt, *args):   # quiet
                pass

            def parse_request(self):
                """Fast path for plain HTTP/1.0-1.1 requests: the stock
                parser routes headers through email.parser at ~0.2ms per
                request. Anything unusual (odd request line, HTTP/0.9,
                oversized headers) falls back to the stock parser, which
                re-reads from ``raw_requestline`` (no header bytes
                consumed)."""
                line = str(self.raw_requestline, "iso-8859-1")
                words = line.rstrip("\r\n").split()
                if len(words) != 3 or words[2] not in ("HTTP/1.1",
                                                       "HTTP/1.0"):
                    return BaseHTTPRequestHandler.parse_request(self)
                self.requestline = line.rstrip("\r\n")
                self.command, self.path, self.request_version = words
                headers = _FastHeaders()
                prev = None
                while True:
                    raw = self.rfile.readline(65537)
                    if len(raw) > 65536:
                        self.send_error(431)
                        return False
                    if raw in (b"\r\n", b"\n", b""):
                        break
                    if raw[:1] in (b" ", b"\t") and prev is not None:
                        headers[prev] += " " + raw.strip().decode(
                            "iso-8859-1")
                        continue
                    k, _, v = raw.partition(b":")
                    prev = k.decode("iso-8859-1").strip().lower()
                    headers[prev] = v.strip().decode("iso-8859-1")
                self.headers = headers
                conntype = headers.get("connection", "").lower()
                if conntype == "close":
                    self.close_connection = True
                elif self.request_version == "HTTP/1.1":
                    self.close_connection = False
                else:
                    self.close_connection = conntype != "keep-alive"
                if headers.get("expect", "").lower() == "100-continue" \
                        and self.protocol_version >= "HTTP/1.1" \
                        and self.request_version >= "HTTP/1.1":
                    if not self.handle_expect_100():
                        return False
                return True

            def do_GET(self):
                outer._handle(self)

            def do_POST(self):
                outer._handle(self)

        class _Server(ThreadingHTTPServer):
            # stdlib default listen backlog is 5: a burst of concurrent
            # clients overflows it and every overflowed connect stalls a
            # full SYN-retransmission timeout (~1s)
            request_queue_size = 128

            # the same logical root as _handle below, marked at the
            # per-connection thread's spawn target: samples taken while
            # the stdlib parses the request line or flushes the response
            # (no _handle frame on the stack) still attribute to
            # "http-handler"
            @thread_root("http-handler")
            def process_request_thread(self, request, client_address):
                ThreadingHTTPServer.process_request_thread(
                    self, request, client_address)

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None
        # extra accept edges (add_listener): (socket, accept thread)
        self._extra_listeners: list = []

    # -- lifecycle --------------------------------------------------------
    @thread_root("accept-edge")
    def _serve_private(self) -> None:
        # the private port's accept loop shares the "accept-edge" root
        # with add_listener's extra edges, and gives the sampling
        # profiler a frame to attribute
        self.httpd.serve_forever()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve_private,
                                        daemon=True, name="accept-edge")
        self._thread.start()

    def add_listener(self, sock) -> None:
        """Attach an extra listening socket (the shared public accept edge
        of a supervised worker: bound with SO_REUSEPORT, or inherited from
        the supervisor where the platform lacks it). Its connections are
        handled by the same per-connection handler threads as the private
        port: one HTTP surface, two accept edges."""
        @thread_root("accept-edge")
        def accept_loop():
            while True:
                try:
                    conn, addr = sock.accept()
                except OSError:
                    return          # socket closed by stop()
                try:
                    # ThreadingMixIn starts the handler thread
                    self.httpd.process_request(conn, addr)
                except Exception:   # noqa: BLE001 — the edge must not die
                    try:
                        conn.close()
                    except OSError:
                        pass
        t = threading.Thread(
            target=accept_loop, daemon=True,
            name=f"accept-edge-{len(self._extra_listeners)}")
        self._extra_listeners.append((sock, t))
        sock.settimeout(None)
        t.start()

    def stop(self) -> None:
        for sock, _t in self._extra_listeners:
            try:
                sock.close()
            except OSError:
                pass
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request handling -------------------------------------------------
    # the stdlib ThreadingHTTPServer spawns one handler thread per
    # connection, a spawn the static analyser cannot see, so the entry
    # point is marked: every query and admin path below runs on one of
    # these roots beside the ingest, detector and worker threads
    @thread_root("http-handler")
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        """Read one request, route it, map a refusal or an error to its
        status, write the answer. A traced request to a query endpoint
        (not a peer hop's, which records under the caller's context)
        starts its trace here, before the admission gate: the root span
        ``request`` runs from this handler's start to the response's
        last byte written, tagged ``path`` and ``status``; under it
        ``admission-wait``, the query path's ``query`` and ``respond``
        (the write, tagged ``bytes``)."""
        t_req = time.time_ns()
        try:
            parsed, qs, body_raw, body_json = self._read_request(req)
            # propagated trace context (Dapper-style): a peer hop's
            # header makes this node record spans under the caller's
            # trace and ship them back in the response envelope
            tctx = obs_trace.parse_context(
                req.headers.get(obs_trace.HEADER))
            tr = self._request_trace(parsed.path, qs, tctx)
        except Exception as e:   # noqa: BLE001 — edge must not crash
            self._respond(req, *self._error_answer(e))
            return
        with obs_trace.activate(tr), \
                obs_trace.span("request", path=parsed.path) as rsp:
            if tr is not None:
                # the request's read and parse belong to it too
                rsp.start_ns = t_req
            retry_after_s: Optional[float] = None
            try:
                code, payload = self._route(
                    parsed.path, qs, body_raw, body_json=body_json,
                    tctx=tctx,
                    tenant_hdr=req.headers.get(qos.TENANT_HEADER),
                    priority_hdr=req.headers.get(qos.PRIORITY_HEADER))
            except Exception as e:   # noqa: BLE001 — edge must not crash
                code, payload, retry_after_s = self._error_answer(e)
            rsp.tag(status=code)
            # the retention decision of a request whose query path never
            # ran (a 429 at the gate, a bad route); made once, so a no-op
            # after the query path's own
            self.tracer.finish_request(
                tr, error=code >= 400,
                duration_ms=(time.time_ns() - t_req) / 1e6)
            self._respond(req, code, payload, retry_after_s)

    def _read_request(self, req: BaseHTTPRequestHandler):
        """(parsed URL, query params, raw body, JSON body): a POST's form
        fields join the query params."""
        parsed = urllib.parse.urlparse(req.path)
        qs = urllib.parse.parse_qs(parsed.query)
        body_raw = b""
        body_json = None
        if req.command == "POST":
            ln = int(req.headers.get("Content-Length") or 0)
            if ln > (64 << 20):     # request-size cap (DoS guard)
                raise _Handled(413, prom_json.error(
                    "request body too large"))
            body_raw = req.rfile.read(ln) if ln else b""
            ctype = req.headers.get("Content-Type", "")
            if "application/x-www-form-urlencoded" in ctype:
                for k, v in urllib.parse.parse_qs(
                        body_raw.decode()).items():
                    qs.setdefault(k, []).extend(v)
            elif "application/json" in ctype and body_raw:
                body_json = json.loads(body_raw)
        return parsed, qs, body_raw, body_json

    def _request_trace(self, path: str, qs: Dict, tctx):
        """The trace of a request to a query endpoint, started before its
        admission wait; None for other paths, peer hops (the query path
        records those under the caller's context) and untraced
        requests. ``&explain=trace|analyze`` forces one."""
        if tctx is not None:
            return None
        m = _ROUTE.match(path)
        if m is None or m.group("rest") not in ("query_range", "query"):
            return None
        return self.tracer.start(force=self._param(qs, "explain") in (
            "trace", "analyze"))

    @staticmethod
    def _error_answer(e: Exception):
        """An exception out of a request's handling -> (status, payload,
        Retry-After seconds or None)."""
        if isinstance(e, _Handled):
            return e.code, e.payload, None
        if isinstance(e, qos.AdmissionRejected):
            # admission said no and no degraded answer exists: 429 +
            # Retry-After. Distinct from the 503 deadline path below —
            # a rejected query was never executed, so the client can
            # back off and resubmit as-is.
            return 429, prom_json.error(str(e), "throttled"), \
                e.retry_after_s
        if isinstance(e, DeadlineExceeded):
            # clean budget-exhaustion error (Prometheus timeout shape),
            # never a hung socket
            return 503, prom_json.error(str(e), "timeout"), None
        if isinstance(e, ingest_health.IngestReadOnly):
            # the ingest edge while write-path out-of-space degradation
            # is active: recoverable — resubmit after space is freed
            return 503, prom_json.error(str(e), "read_only"), \
                e.retry_after_s
        if isinstance(e, QueryLimitError):
            return 422, prom_json.error(str(e), "query_limit"), None
        if isinstance(e, QueryError):
            return 400, prom_json.error(str(e)), None
        return 500, prom_json.error(str(e), "internal"), None

    @staticmethod
    def _respond(req: BaseHTTPRequestHandler, code: int, payload,
                 retry_after_s: Optional[float]) -> None:
        """Encode and write one answer; the write (flushed here, not
        after the handler returns) is the traced request's ``respond``
        span."""
        extra_headers = {}
        if retry_after_s is not None:
            extra_headers["Retry-After"] = str(
                max(1, int(retry_after_s + 0.999)))
        if isinstance(payload, prom_json.PreEncoded):
            body = payload.body
            ctype = payload.ctype
        elif isinstance(payload, bytes):  # remote-read protobuf
            body = payload
            ctype = "application/x-protobuf"
            extra_headers["Content-Encoding"] = "snappy"
        elif isinstance(payload, str):  # /metrics exposition text
            body = payload.encode()
            ctype = "text/plain; version=0.0.4"
        else:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        with obs_trace.span("respond", bytes=len(body)):
            req.send_response(code)
            req.send_header("Content-Type", ctype)
            for k, v in extra_headers.items():
                req.send_header(k, v)
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
            req.wfile.flush()

    def _route(self, path: str, qs: Dict, body_raw: bytes = b"",
               body_json=None, tctx=None, tenant_hdr: Optional[str] = None,
               priority_hdr: Optional[str] = None):
        if path in ("/__health", "/__liveness", "/__readiness"):
            # the health body doubles as status gossip: locally-served
            # shards with their FSM status (peers sync these instead of
            # optimistically flipping adopted shards ACTIVE), this node's
            # own down-view of its peers (quorum input for elastic
            # reassignment), per-shard ingest watermarks + backfill
            # epochs, and the integrity flags (HealthRoute + the
            # reference's gossip body)
            shards_adv: Dict[str, str] = {}
            watermarks: Dict[str, int] = {}
            epochs: Dict[str, int] = {}
            quarantined: Dict[str, int] = {}
            integrity_ro: List[str] = []
            for lst in self.user_shard_lists():
                for i, s in enumerate(lst):
                    n = getattr(s, "shard_num", i)
                    if self.shard_mapper is not None:
                        shards_adv[str(n)] = \
                            self.shard_mapper.status(n).value
                    wm = getattr(s, "ingest_watermark_ms", None)
                    if wm is not None:
                        watermarks[str(n)] = int(wm)
                    epochs[str(n)] = int(getattr(
                        s, "ingest_backfill_epoch", 0) or 0)
                    q = int(getattr(
                        s, "integrity_quarantined_records", 0) or 0)
                    if q:
                        quarantined[str(n)] = q
                    if getattr(s, "integrity_read_only", False):
                        integrity_ro.append(str(n))
            down = (sorted(self.detector.down_peers())
                    if self.detector is not None else [])
            body = {"status": "healthy", "shards": shards_adv,
                    "down_peers": down,
                    "watermarks": watermarks,
                    "backfill_epochs": epochs,
                    "ingest_read_only":
                        ingest_health.GLOBAL.read_only(),
                    "integrity": {"quarantined": quarantined,
                                  "read_only_shards": integrity_ro}}
            if self.shard_mapper is not None:
                body["topo_epoch"] = self.shard_mapper.topology_epoch
            mem = self.membership
            if mem is not None:
                body["draining"] = bool(mem.draining)
            gs = self.grpc_server
            if gs is not None:
                # advertise the data-plane port; peers combine it with
                # this node's known host (gossip discovery for
                # ephemeral-port deployments)
                body["grpc_port"] = gs.port
            # introspection: which peers this node has discovered
            body["grpc_peers"] = dict(self.grpc_peers)
            return 200, body
        if path == "/metrics":
            # ?exemplars=1: OpenMetrics exemplar suffixes on histogram
            # buckets; the plain exposition stays byte-identical without
            want_ex = (self._param(qs, "exemplars", "")
                       or "").lower() in ("1", "true", "yes")
            return 200, self._metrics_text(exemplars=want_ex)
        if path.startswith("/admin/"):
            return self._admin(path, qs, body_json)
        if path == "/debug/traces":
            return 200, self._debug_traces(qs)
        if path == "/debug/profile":
            return self._debug_profile(qs)
        if path == "/debug/queries":
            return 200, {"status": "success",
                         "data": self.inflight.snapshot()}
        if path == "/debug/threads":
            # the @thread_root inventory: every registered thread entry
            # point with its module-qualified root function, the
            # @guarded_by summary of its class, and which live threads
            # run it now (joined against threading.enumerate())
            from filodb_tpu_torch.lint.threads import thread_inventory
            return 200, {"status": "success",
                         "data": thread_inventory()}
        if path == "/debug/events":
            # the structured operational journal (obs/events.py), newest
            # first
            limit = int(self._param(qs, "limit", "100") or 100)
            kind = self._param(qs, "kind", None)
            return 200, {"status": "success",
                         "data": obs_events.snapshot(limit=limit,
                                                     kind=kind)}
        if path == "/api/v1/ingest/influx":
            return self._ingest_influx(body_raw)
        if path == "/debug/slow_queries":
            limit = int(self._param(qs, "limit", "50") or 50)
            return 200, {"status": "success",
                         "summary": self.slow_log.snapshot(),
                         "data": self.slow_log.records(limit)}
        if path == "/api/v1/rules":
            return self._rules_api(qs)
        if path == "/api/v1/alerts":
            return self._alerts_api(qs)
        m = re.match(r"^/api/v1/cluster/(?P<ds>[^/]+)/status$", path)
        if m:
            return 200, self._cluster_status(m.group("ds"))
        m = re.match(r"^/api/v1/raw/(?P<ds>[^/]+)$", path)
        if m:
            return self._raw_dispatch(m.group("ds"), body_json, tctx=tctx)
        m = re.match(r"^/api/v1/cardinality(?P<local>-local)?/(?P<ds>[^/]+)$",
                     path)
        if m:
            return self._cardinality(m.group("ds"), qs,
                                     local=bool(m.group("local")))
        m = _ROUTE.match(path)
        if not m:
            return 404, prom_json.error(f"no route for {path}", "not_found")
        ds, rest = m.group("ds"), m.group("rest")
        # dispatch=local: a forwarded query must evaluate on this node's
        # shards only (no fan-back-out; loop prevention for pushdown —
        # federation forwarding is likewise disabled)
        local_dispatch = self._param(qs, "dispatch") == "local"
        # degraded-mode knobs: per-query deadline budget (&timeout=,
        # Prom-style) + opt-in partial responses (&allow_partial=true,
        # the Thanos partial_response analogue; default fail-fast)
        timeout_s = self._parse_duration_s(
            self._param(qs, "timeout"), self.query_timeout_s)
        deadline = Deadline.after(timeout_s)
        allow_partial = (self._param(qs, "allow_partial", "")
                         or "").lower() in ("true", "1", "yes")
        # &cache=false: results-cache escape hatch — this query neither
        # reads nor seeds the cache, and pushdown hops propagate the flag
        no_cache = (self._param(qs, "cache", "")
                    or "").lower() in ("false", "0", "no")
        if rest in ("query_range", "query"):
            # stale-routing bounce (pushdown plane): a dispatch=local hop
            # names the shards the entry node expects this peer to serve;
            # if a handoff moved one away, bounce with the new owners
            # instead of silently evaluating over a subset
            if local_dispatch:
                raw_expect = self._param(qs, "expect_shards")
                if raw_expect:
                    try:
                        want = [int(x) for x in raw_expect.split(",")
                                if x]
                    except ValueError:
                        raise QueryError(
                            f"bad expect_shards {raw_expect!r}")
                    missing = [n for n in want
                               if n not in self._local_shard_nums(ds)]
                    if missing:
                        return 200, self._stale_routing_payload(missing)

            def mk_engine():
                eng = self.make_planner(ds, local_dispatch=local_dispatch,
                                        deadline=deadline,
                                        allow_partial=allow_partial,
                                        no_result_cache=no_cache)
                if eng is None:
                    raise QueryError(f"dataset {ds} not set up")
                return eng
            if rest == "query_range":
                fn = lambda eng: self._query_range(  # noqa: E731
                    eng, qs, ds, tctx=tctx)
            else:
                fn = lambda eng: self._query_instant(  # noqa: E731
                    eng, qs, ds, tctx=tctx)
            # tenant QoS: identity from &tenant= / X-Filo-Tenant (by
            # convention the workspace), priority class from &priority= /
            # X-Filo-Priority. A dispatch=local hop is a fan-out LEG: the
            # entry node already made the admission decision, so the leg
            # force-charges and never sheds. The reserved internal
            # tenants charge FORCED too and run at the background class
            # unless a priority was explicit.
            tenant = (self._param(qs, "tenant") or tenant_hdr
                      or qos.DEFAULT_TENANT)
            raw_priority = self._param(qs, "priority") or priority_hdr
            priority = qos.parse_priority(raw_priority)
            internal_tenant = tenant in qos.INTERNAL_TENANTS
            if internal_tenant and not raw_priority:
                priority = qos.PRIORITY_BACKGROUND
            qctx = qos.QosContext(tenant=tenant, priority=priority,
                                  forced=local_dispatch or internal_tenant)
            adm = self.admission
            try:
                if not adm.gated:
                    with qos.activate(qctx):
                        code, payload = self._run_query_routing_retry(
                            mk_engine, fn)
                else:
                    with adm.slot(tenant=qctx.tenant):
                        with qos.activate(qctx):
                            code, payload = \
                                self._run_query_routing_retry(
                                    mk_engine, fn)
            except qos.AdmissionRejected as e:
                # host saturation leaves one free rung: a stale cached
                # extent costs neither a slot nor compute. Over-budget
                # rejections already walked the full ladder — re-raise.
                if e.reason != "saturated" or rest != "query_range":
                    raise
                out = self._shed_stale_saturated(ds, qs, qctx, deadline,
                                                 no_cache)
                if out is None:
                    raise
                code, payload = out
            if local_dispatch and isinstance(payload, dict) \
                    and self.shard_mapper is not None:
                # a pushdown hop's response carries the responder's
                # topology epoch alongside the result (client-facing
                # responses are untouched — this is the peer plane)
                payload["topo_epoch"] = self.shard_mapper.topology_epoch
            return code, payload
        if rest == "read":
            return self._remote_read(ds, body_raw)
        engine = self.make_planner(ds, local_dispatch=local_dispatch,
                                   deadline=deadline,
                                   allow_partial=allow_partial,
                                   no_result_cache=no_cache)
        if engine is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        if rest == "labels":
            return self._labels(engine, qs, ds)
        lm = re.match(r"^label/(?P<name>[^/]+)/values$", rest)
        if lm:
            return self._label_values(engine, lm.group("name"), qs, ds)
        if rest == "series":
            return self._series(engine, qs, ds)
        return 404, prom_json.error(f"no route for {path}", "not_found")

    # -- elastic membership admin plane -----------------------------------
    def _admin(self, path: str, qs: Dict, body: Optional[Dict]):
        """POST /admin/drain | /admin/adopt | /admin/transfer |
        /admin/abort_adopt — the planned-membership control plane
        (parallel/membership.py). Peer-facing endpoints answer HTTP 200
        with a status envelope like the query plane, so callers share
        one error-handling path."""
        mem = self.membership
        if mem is None:
            return 400, prom_json.error(
                "elastic membership is not enabled on this node")
        body = body or {}
        if path == "/admin/drain":
            timeout = self._param(qs, "timeout")
            out = mem.drain(timeout_s=float(timeout)
                            if timeout else None)
            return 200, {"status": "success", "data": out}
        if path == "/admin/adopt":
            if body.get("shard") is None:
                return 400, prom_json.error("adopt: missing shard")
            out = mem.accept_adopt(int(body["shard"]),
                                   str(body.get("from") or ""))
            return 200, {"status": "success", "data": out}
        if path == "/admin/transfer":
            if body.get("shard") is None or not body.get("owner"):
                return 400, prom_json.error(
                    "transfer: missing shard/owner")
            out = mem.apply_transfer(int(body["shard"]),
                                     str(body["owner"]))
            return 200, {"status": "success", "data": out}
        if path == "/admin/abort_adopt":
            if body.get("shard") is None:
                return 400, prom_json.error("abort_adopt: missing shard")
            out = mem.abort_adopt(int(body["shard"]),
                                  str(body.get("owner") or ""))
            return 200, {"status": "success", "data": out}
        return 404, prom_json.error(f"no route for {path}", "not_found")

    # -- recording rules & alerting (rules/) ------------------------------
    def _rules_proxy(self, path: str, qs: Dict):
        """Only ONE process of a fleet evaluates rules; a request landing
        on a stand-by proxies to the evaluator's address so clients see
        authoritative state. ``__local__`` breaks proxy loops when
        elections disagree for a beat. Returns None when no proxy applies
        (answer locally)."""
        eng = self.rules
        if eng is None or qs.get("__local__"):
            return None
        snap = eng.snapshot()
        if snap["active"]:
            return None
        target = self.peers.get(f"node{eng.evaluator_ordinal()}")
        if not target:
            return None
        import urllib.request as ureq
        q = {k: v for k, v in qs.items()}
        q["__local__"] = ["1"]
        url = (target.rstrip("/") + path + "?"
               + urllib.parse.urlencode(q, doseq=True))
        try:
            with ureq.urlopen(url, timeout=5) as r:
                return 200, json.loads(r.read())
        except (OSError, ValueError):
            return None     # fall back to the local (stand-by) view

    def _rules_api(self, qs: Dict):
        """GET /api/v1/rules (Prometheus rules API shape). Extensions:
        ``&explain=analyze`` inlines each rule's retained last evaluation
        (query, exact range, cache dispositions, duration, error);
        ``&debug`` adds the scheduler and election state."""
        proxied = self._rules_proxy("/api/v1/rules", qs)
        if proxied is not None:
            return proxied
        eng = self.rules
        if eng is None:
            return 200, {"status": "success",
                         "data": {"groups": [], "evaluating": False}}
        explain = self._param(qs, "explain") == "analyze"
        data = eng.rules_payload(explain=explain)
        if self._param(qs, "debug"):
            data["debug"] = eng.snapshot()
        return 200, {"status": "success", "data": data}

    def _alerts_api(self, qs: Dict):
        """GET /api/v1/alerts: active alert instances and the bounded
        ring of state transitions."""
        proxied = self._rules_proxy("/api/v1/alerts", qs)
        if proxied is not None:
            return proxied
        eng = self.rules
        if eng is None:
            return 200, {"status": "success", "data": {"alerts": []}}
        return 200, {"status": "success", "data": eng.alerts_payload()}

    def rule_eval_range(self, ds: str, query: str, plan,
                        start_ms: int, step_ms: int, end_ms: int):
        """One standing-query evaluation for the rules engine, through
        the normal serving path: the plan-cost charge (FORCED, on the
        reserved ``__rules__`` tenant: standing evaluation never bounces
        off a drained bucket), the results-cache split (the tick is a
        step-aligned tail recompute: the warm prefix serves from the
        cache, only the newest step materializes) and the engine at
        BACKGROUND priority in the micro-batcher. Returns ``(result,
        stages)``; the stages carry the cache dispositions the engine
        keeps per rule for ``/api/v1/rules?explain=analyze``. No
        admission slot is taken: the scheduler is one standing consumer,
        not a burst of client connections."""
        deadline = Deadline.after(self.query_timeout_s)
        engine = self.make_planner(ds, deadline=deadline)
        if engine is None:
            raise QueryError(f"rules: dataset {ds} not set up")
        stages: Dict[str, object] = {}
        qctx = qos.QosContext(tenant=qos.RULES_TENANT,
                              priority=qos.PRIORITY_BACKGROUND,
                              forced=True)
        with qos.activate(qctx):
            with obs_trace.span("rule-eval", query=query, dataset=ds):
                # forced context: charges the reserved tenant's bucket
                # and returns None (rule evaluation is never shed)
                self._charge_or_shed(engine, {}, ds, query, plan,
                                     start_ms // 1000, end_ms // 1000,
                                     step_ms // 1000, stages)
                ses = self.result_cache.begin(
                    engine, ds, query, plan, start_ms, step_ms, end_ms)
                exs = [engine.materialize(p) for p in ses.plans]
                res = ses.finish(engine, [ex.execute() for ex in exs])
        stages["resultCache"] = ses.state
        stages["cachedSteps"] = ses.cached_steps
        if isinstance(res, GridResult):
            stages["series"] = res.num_series
            if res.partial:
                stages["partial"] = True
        return res, stages

    def _local_shard_nums(self, ds: str) -> set:
        return {getattr(s, "shard_num", i)
                for i, s in enumerate(self.shards_by_dataset.get(ds, ()))}

    def _stale_routing_payload(self, missing) -> Dict:
        """The bounce envelope a peer returns instead of silently
        evaluating over a subset of the shards the caller routed at it:
        names the owners THIS node's mapper records (it witnessed the
        handoff), so the caller can rewire and retry."""
        owners = {}
        if self.shard_mapper is not None:
            owners = {str(n): self.shard_mapper.node_of(n)
                      for n in missing}
        epoch = getattr(self.shard_mapper, "topology_epoch", 0) \
            if self.shard_mapper is not None else 0
        self.stale_routing_bounces += 1
        err = StaleRoutingError(
            owners={int(k): v for k, v in owners.items()},
            epoch=epoch, node=self.node_id or "",
            detail="shards %s are not served here" % sorted(missing))
        return {"status": "error", "errorType": "stale_routing",
                "error": str(err), "owners": owners,
                "topo_epoch": epoch}

    def _apply_owner_hints(self, e: StaleRoutingError) -> None:
        """Fold a stale-routing responder's owner map into the local
        mapper before re-materializing: the responder is the former
        owner and witnessed the handoff. Hints naming unknown nodes —
        or claiming THIS node serves a shard it doesn't — are ignored
        (the retry then waits for gossip/transfer to converge)."""
        if self.shard_mapper is None:
            return
        from filodb_tpu_torch.parallel.shardmapper import ShardStatus
        local = {n for lst in self.user_shard_lists()
                 for n in (getattr(s, "shard_num", i)
                           for i, s in enumerate(lst))}
        for sh, owner in sorted(e.owners.items()):
            if not owner or not (0 <= sh < self.shard_mapper.num_shards):
                continue
            if owner == self.node_id:
                if sh not in local:
                    continue        # bogus hint: we don't serve it
            elif owner not in self.peers:
                continue
            if self.shard_mapper.node_of(sh) != owner:
                self.shard_mapper.assign(sh, owner)
                self.shard_mapper.update(sh, ShardStatus.ACTIVE, owner)

    def _run_query_routing_retry(self, mk_engine, fn):
        """Execute a query, re-resolving routing on StaleRoutingError:
        a peer mid-/post-handoff bounced rather than answer for shards
        it no longer serves. The bounce carries the new owners; apply
        them, drop cached plans/results keyed on the stale world, and
        re-materialize. A stale-epoch peer response is therefore never
        returned to a client — the query either converges on fresh
        routing or fails loudly after bounded attempts."""
        import time as _time
        attempts = 3
        for i in range(attempts):
            try:
                return fn(mk_engine())
            except StaleRoutingError as e:
                self.stale_routing_retries += 1
                self._apply_owner_hints(e)
                # plans are routing-independent but the results cache
                # keys on the topology world: drop both (the listener
                # wiring clears the results cache too)
                self.plan_cache.invalidate("stale-routing")
                if i == attempts - 1:
                    raise QueryError(
                        "shard routing did not converge after "
                        f"{attempts} attempts: {e.detail or e}")
                _time.sleep(0.05 * (i + 1))

    # -- tenant QoS: cost admission + the shed-to-degraded ladder ---------
    def _charge_or_shed(self, engine, qs, ds: str, query: str, plan,
                        start: int, end: int, step: int,
                        stages: Dict) -> Optional[Tuple[int, object]]:
        """Charge the parsed plan's estimated cost to the tenant's
        budget. Returns None when the query may proceed normally, a
        ``(code, payload)`` degraded answer when the tenant is over
        budget but the ladder produced one, and raises
        :class:`~filodb_tpu_torch.query.qos.AdmissionRejected` (429 +
        Retry-After) when it did not."""
        adm = self.admission
        qctx = qos.current()
        if qctx is None or not adm.budgets.enabled:
            return None
        bucket = adm.budgets.bucket(qctx.tenant)
        if bucket is None:
            return None                     # unbudgeted tenant
        if qctx.forced:
            # reserved internal tenant: charge, never shed
            bucket.charge_forced(engine.estimate_cost(plan).total)
            return None
        if bucket.remaining() <= 0.0:
            # drained-bucket fast path: nothing can charge, so skip plan
            # pricing entirely — a tight-loop abuser ignoring Retry-After
            # must not buy repeated cost walks with each rejection. Only
            # the (charged) stale rung can answer.
            bucket.note_throttled()
            qctx.degraded = True
            qctx.priority = qos.PRIORITY_BEST_EFFORT
            out = self._shed_degraded(engine, qs, ds, query, plan,
                                      start, end, step, stages,
                                      drained=True)
            if out is not None:
                return out
            adm.budgets.record_rejected(qctx.tenant)
            raise qos.AdmissionRejected(
                f"tenant {qctx.tenant!r} has exhausted its query "
                f"budget and no degraded answer exists",
                retry_after_s=bucket.retry_after_s(bucket.burst),
                tenant=qctx.tenant, reason="over-budget")
        cost = engine.estimate_cost(plan).total
        stages["qosCost"] = round(cost, 1)
        if bucket.try_charge(cost):
            return None
        # over budget: the tenant's own work degrades; everyone else
        # is untouched. Executions below run at best-effort priority so
        # the batcher never lets them head-of-line block interactive
        # queries.
        qctx.degraded = True
        qctx.priority = qos.PRIORITY_BEST_EFFORT
        obs_trace.event("qos-shed", tenant=qctx.tenant,
                        cost=round(cost, 1))
        out = self._shed_degraded(engine, qs, ds, query, plan,
                                  start, end, step, stages)
        if out is not None:
            return out
        adm.budgets.record_rejected(qctx.tenant)
        if cost > bucket.burst:
            # the query prices above burst: it can NEVER charge cleanly
            # no matter how long the client waits. Name the alternative
            # that WOULD fit instead, or say explicitly that nothing does.
            alt = self._never_admittable_alternative(
                engine, plan, start, end, step, bucket.burst)
            if alt is not None:
                kind, alt_step, alt_cost = alt
                hint = (f"retry with step>={alt_step}s (estimated "
                        f"cost {alt_cost:.0f} fits the burst)"
                        if kind == "coarsen" else
                        f"retry the newest slice only (estimated "
                        f"cost {alt_cost:.0f} fits the burst)")
                raise qos.AdmissionRejected(
                    f"tenant {qctx.tenant!r}: estimated cost "
                    f"{cost:.0f} exceeds the budget's burst capacity "
                    f"{bucket.burst:.0f} and can never admit cleanly; "
                    f"{hint}",
                    retry_after_s=bucket.retry_after_s(alt_cost),
                    tenant=qctx.tenant, reason="never-admittable")
            raise qos.AdmissionRejected(
                f"tenant {qctx.tenant!r}: estimated cost {cost:.0f} "
                f"exceeds the budget's burst capacity "
                f"{bucket.burst:.0f} at every degraded resolution — "
                f"never admittable under this tenant's budget; raise "
                f"the budget or narrow the query",
                retry_after_s=None,
                tenant=qctx.tenant, reason="never-admittable")
        raise qos.AdmissionRejected(
            f"tenant {qctx.tenant!r} is over its query budget "
            f"(estimated cost {cost:.0f}) and no degraded answer "
            f"exists",
            retry_after_s=adm.budgets.retry_after_s(qctx.tenant, cost),
            tenant=qctx.tenant, reason="over-budget")

    def _never_admittable_alternative(self, engine, plan, start: int,
                                      end: int, step: int,
                                      burst: float):
        """A cheaper shape of the same query that CAN admit cleanly
        under ``burst``, for the never-admittable 429 body:
        ``("coarsen", step_s, cost)`` (preferred — the resolution the
        degrade ladder would pick), ``("partial", step_s, cost)`` for
        the newest-slice shape, or None when even those price above
        burst."""
        if step <= 0:
            return None
        from filodb_tpu_torch.query.engine import lp_replace_range
        coarse = qos.coarsen_step_s(start, step, end,
                                    self.qos_degrade_max_steps)
        try:
            if coarse > step:
                plan_b = lp_replace_range(plan, start * 1000,
                                          coarse * 1000, end * 1000)
                c = engine.estimate_cost(plan_b).total
                if c <= burst:
                    return ("coarsen", coarse, c)
            n_steps = (end - start) // step + 1
            if n_steps > 4:
                keep = max(1, n_steps // 8)
                start_c = start + (n_steps - keep) * step
                plan_c = lp_replace_range(plan, start_c * 1000,
                                          step * 1000, end * 1000)
                c = engine.estimate_cost(plan_c).total
                if c <= burst:
                    return ("partial", step, c)
        except Exception:   # noqa: BLE001 — a hint must never 500
            return None
        return None

    def _shed_degraded(self, engine, qs, ds: str, query: str, plan,
                       start: int, end: int, step: int,
                       stages: Dict, drained: bool = False
                       ) -> Optional[Tuple[int, object]]:
        """The brownout ladder, in order of preference:

        1. **stale-cache** — an overlapping results-cache extent served
           past the freshness horizon (costs nothing; correctness
           invalidators still apply — stale, never wrong);
        2. **downsample** — re-plan at a coarser step through the
           normal materialize path, and so through the raw/downsample
           tiering where a ds store is set;
        3. **partial** — evaluate only the newest slice of the range
           and return it via the partial-results plumbing.

        Rungs 2-3 still charge their (much smaller) estimated cost —
        a tenant deep in debt gets neither. Every rung stamps a
        ``shed(...)`` warning naming itself, so clients and dashboards
        see exactly what they got. Returns None when no rung applies
        (the caller answers 429 + Retry-After)."""
        qctx = qos.current()
        tenant = qctx.tenant if qctx is not None else qos.DEFAULT_TENANT
        budgets = self.admission.budgets
        if not self.qos_shed_degraded or step <= 0:
            return None
        start_ms, step_ms, end_ms = start * 1000, step * 1000, end * 1000
        # rung 1: stale cache (skipped when the client explicitly sent
        # &cache=false — the escape hatch means "never answer me from
        # cached state", stale least of all)
        bypass = (self._param(qs, "cache", "")
                  or "").lower() in ("false", "0", "no")
        grid = None if bypass else \
            self.result_cache.stale_serve(engine, ds, query, plan,
                                          start_ms, step_ms, end_ms)
        if grid is not None and budgets.try_charge(
                tenant, qos.stale_serve_cost(grid.num_series,
                                             grid.values.shape[1])):
            # a stale serve is cheap but not free (encode-only cost
            # charged above): the budget bounds the tenant's TOTAL
            # work, degraded serving included
            grid.warnings.append(
                f"shed(stale-cache): tenant {tenant!r} over budget; "
                f"served cached extent past the freshness horizon")
            budgets.record_degraded(tenant, "stale")
            obs_trace.event("qos-shed", rung="stale", tenant=tenant)
            stages["qosShed"] = "stale"
            return 200, self._encode_degraded(engine, grid, qs)
        if drained:
            # deep debt: the compute rungs below could never charge —
            # don't pay their plan walks either
            return None
        from filodb_tpu_torch.query.engine import lp_replace_range

        def run_rung(rung: str, plan_x, note: str,
                     partial: bool = False):
            """Charge + execute one compute rung. An EXECUTION failure
            refunds the rung's charge and falls through to the next rung
            / terminal 429 — it must never surface as a 400: the client
            sent a valid query, the degraded answer just wasn't
            available. Deadline exhaustion keeps its own 503 shape."""
            cost_x = engine.estimate_cost(plan_x).total
            if not budgets.try_charge(tenant, cost_x):
                return None
            obs_trace.event("qos-shed", rung=rung, tenant=tenant)
            try:
                res = engine.materialize(plan_x).execute()
            except (DeadlineExceeded, qos.AdmissionRejected):
                raise
            except Exception as e:     # noqa: BLE001 — fall to next rung
                budgets.refund(tenant, cost_x)
                obs_trace.event("qos-shed-failed", rung=rung,
                                tenant=tenant, error=str(e)[:200])
                return None
            budgets.record_degraded(tenant, rung)
            stages["qosShed"] = rung
            if isinstance(res, GridResult):
                res.partial = res.partial or partial
                res.warnings.append(note)
                return 200, self._encode_degraded(engine, res, qs)
            if isinstance(res, ScalarResult):
                return 200, prom_json.scalar(res, instant=False)
            return None

        # rung 2: coarser resolution
        coarse = qos.coarsen_step_s(start, step, end,
                                    self.qos_degrade_max_steps)
        if coarse > step:
            plan_b = lp_replace_range(plan, start_ms, coarse * 1000,
                                      end_ms)
            out = run_rung(
                "downsample", plan_b,
                f"shed(downsample): tenant {tenant!r} over budget; "
                f"step coarsened {step}s -> {coarse}s")
            if out is not None:
                return out
        # rung 3: newest-slice partial
        n_steps = (end - start) // step + 1
        if n_steps > 4:
            keep = max(1, n_steps // 8)
            start_c = start + (n_steps - keep) * step
            plan_c = lp_replace_range(plan, start_c * 1000, step_ms,
                                      end_ms)
            out = run_rung(
                "partial", plan_c,
                f"shed(partial): tenant {tenant!r} over budget; "
                f"returned newest {keep}/{n_steps} steps",
                partial=True)
            if out is not None:
                return out
        return None

    def _shed_stale_saturated(self, ds: str, qs: Dict, qctx, deadline,
                              no_cache: bool
                              ) -> Optional[Tuple[int, object]]:
        """Host-saturation fallback: the bounded admission wait timed
        out, but a stale cached extent needs neither a slot nor
        compute — parse (plan cache) and look it up. None when there
        is no usable extent or the client sent &cache=false (the caller
        answers 429)."""
        if no_cache or not self.qos_shed_degraded:
            return None
        query = self._param(qs, "query")
        if not query:
            return None
        try:
            start = int(float(self._param(qs, "start", "0")))
            end = int(float(self._param(qs, "end", "0")))
            step = int(float(self._param(qs, "step", "10")))
        except ValueError:
            return None
        if step <= 0 or end < start:
            return None
        engine = self.make_planner(ds, deadline=deadline)
        if engine is None:
            return None
        plan = self.plan_cache.lookup(ds, query, start * 1000,
                                      step * 1000, end * 1000)
        if plan is None:
            plan = parse_query_range(query,
                                     TimeStepParams(start, step, end))
            self.plan_cache.store(ds, query, start * 1000, step * 1000,
                                  end * 1000, plan)
        grid = self.result_cache.stale_serve(
            engine, ds, query, plan, start * 1000, step * 1000,
            end * 1000)
        if grid is None:
            return None
        if not self.admission.budgets.try_charge(
                qctx.tenant, qos.stale_serve_cost(
                    grid.num_series, grid.values.shape[1])):
            return None         # budget bounds degraded serving too
        grid.warnings.append(
            "shed(stale-cache): host saturated; served cached extent "
            "past the freshness horizon")
        self.admission.budgets.record_degraded(qctx.tenant, "stale")
        return 200, self._encode_degraded(engine, grid, qs)

    def _encode_degraded(self, engine, res: GridResult, qs):
        """Encode a shed-ladder result through the bulk matrix path; the
        warnings/partial markers ride the envelope. Never admitted to
        the results cache (the shed warning trips the degraded guard)."""
        hist_wire = bool(self._param(qs, "hist-wire"))
        stats_json = self._query_stats(engine, res)
        if isinstance(res, GridResult) and not hist_wire \
                and not res.is_hist():
            st = engine.stats
            warnings = list(getattr(st, "warnings", ()) or ())
            warnings.extend(w for w in res.warnings
                            if w not in warnings)
            partial = bool(getattr(st, "partial", False) or res.partial)
            return prom_json.matrix_bytes(res, stats_json,
                                          warnings=warnings,
                                          partial=partial)
        out = prom_json.matrix(res, hist_wire=hist_wire)
        out["stats"] = stats_json
        prom_json.attach_degraded(out, res, engine.stats)
        return out

    @publishes("dispatch-scope")
    def make_planner(self, ds: str, local_dispatch: bool = False,
                     deadline: Optional[Deadline] = None,
                     allow_partial: bool = False,
                     no_result_cache: bool = False):
        """Planner over this node's view of a dataset (shared by the HTTP
        endpoints and the gRPC query service). ``local_dispatch`` pins
        evaluation to local shards — no peer fan-out, no federation. A
        reserved internal dataset is planned over its local shards
        only, with no shard mapper and no cluster plane."""
        shards = self.shards_by_dataset.get(ds)
        if shards is None:
            return None
        if ds in INTERNAL_DATASETS:
            planner = QueryPlanner(
                shards, backend=self.backend, deadline=deadline,
                allow_partial=allow_partial,
                no_result_cache=no_result_cache,
                limits=self.query_limits, dataset=ds,
                node_id=self.node_id)
            planner.metering = self.tenant_metering
            return planner
        peers = {} if local_dispatch else self.peers
        partitions = {} if local_dispatch else self.partitions
        grpc_peers = {} if local_dispatch else self.grpc_peers
        grpc_partitions = {} if local_dispatch else self.grpc_partitions
        # mid-handoff read redirect: shards this node is adopting route
        # back to their still-serving previous owner until replay
        # completes (resolved to URLs here; applies under dispatch=local
        # too — the data is by definition this node's shard set)
        handoff = {}
        if self.handoff_sources:
            down = set(self.detector.down_peers()) \
                if self.detector is not None else set()
            for sh, node in dict(self.handoff_sources).items():
                url = self.peers.get(node)
                if url and node not in down:
                    handoff[sh] = (node, url)
        planner = QueryPlanner(shards, backend=self.backend,
                               handoff_sources=handoff,
                               peer_watermarks=self.peer_watermarks,
                               deadline=deadline,
                               allow_partial=allow_partial,
                               no_result_cache=no_result_cache,
                               resilience=self.resilience,
                               shard_mapper=self.shard_mapper,
                               mesh_executor=self.mesh_executor,
                               spread=self.spread,
                               ds_store=self.ds_store_by_dataset.get(ds),
                               raw_retention_ms=self.raw_retention_ms,
                               limits=self.query_limits,
                               spread_provider=self.spread_provider,
                               node_id=self.node_id, peers=peers,
                               buddies=self.buddies,
                               partitions=partitions,
                               local_partitions=self.local_partitions,
                               dataset=ds,
                               grpc_peers=grpc_peers,
                               grpc_partitions=grpc_partitions,
                               local_dispatch=local_dispatch,
                               plane_fallbacks=self.plane_fallbacks)
        # QoS cost estimation: the metering snapshot prices remote
        # shard groups (local trackers only know local shards)
        planner.metering = self.tenant_metering
        return planner

    def user_shard_lists(self) -> List[list]:
        """The shard lists of the user datasets: the shards the mapper
        routes. An internal dataset's one shard is numbered by worker
        ordinal (``__rules__``, ``__selfmon__``), so its number would
        collide with a user shard's in the health gossip and the bus's
        watermark beats: a node restarting beside a sibling with rules
        would read the sibling's internal shard 1 as a claim on user shard
        1 and defer it (ROADMAP C.19; the reference advertises them)."""
        return [lst for ds, lst in self.shards_by_dataset.items()
                if ds not in INTERNAL_DATASETS]

    @publishes("schema")
    def invalidate_plan_cache(self, reason: str = "schema") -> None:
        """Explicit plan-cache invalidation hook. Topology changes flow
        in automatically via ShardMapper events; callers that change a
        dataset's SCHEMAS must call this so no cached plan outlives the
        world it was parsed against."""
        self.plan_cache.invalidate(reason)

    # -- endpoints --------------------------------------------------------
    @staticmethod
    def _param(qs, name, default=None):
        v = qs.get(name)
        return v[0] if v else default

    @staticmethod
    def _parse_duration_s(raw: Optional[str], default_s: float) -> float:
        """&timeout= value: plain seconds or a Prometheus-style suffixed
        duration (500ms / 30s / 2m / 1h). Bad values keep the default."""
        if not raw:
            return default_s
        try:
            m = re.match(r"^\s*([0-9.]+)\s*(ms|s|m|h)?\s*$", raw)
            if not m:
                return default_s
            v = float(m.group(1))
            scale = {"ms": 1e-3, "s": 1.0, "m": 60.0,
                     "h": 3600.0}.get(m.group(2) or "s", 1.0)
            return max(v * scale, 1e-3)
        except ValueError:
            return default_s

    def _ingest_influx(self, body_raw: bytes):
        """Remote ingest edge: newline-delimited influx lines in the
        POST body, routed through the gateway's builders into the
        per-shard streams. Unlike the fire-and-forget TCP gateway this
        endpoint has an ack channel: 200 means every line's container
        was appended (fsync'd when group commit is off); while ingest
        is degraded to read-only it answers 503 + Retry-After."""
        gw = self.gateway
        if gw is None:
            return 404, prom_json.error(
                "no gateway on this worker (the gateway rides exactly "
                "one worker per host)", "not_found")
        health = ingest_health.GLOBAL
        if health.read_only() and not health.probe_due():
            # fast 503 without touching the disk; the rate-limited
            # probe slot is claimed inside _publish when due
            raise health.reject()
        from filodb_tpu_torch.core.record import RecordBuilder
        builders: Dict[int, RecordBuilder] = {}
        accepted = rejected = 0
        for raw in body_raw.splitlines():
            line = raw.decode("utf-8", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            if gw._route_line(line, builders):
                accepted += 1
            else:
                rejected += 1
        gw._publish(builders, raise_on_error=True)
        return 200, {"status": "success",
                     "data": {"accepted": accepted,
                              "rejected": rejected}}

    def _lint_schema_items(self) -> Tuple:
        """The metric-schema snapshot promlint checks user queries
        against: the recording rules' ``schema:`` declarations, as a
        hashable tuple (the lint memo keys on it; rules may reload)."""
        eng = self.rules
        if eng is None:
            return ()
        return tuple(sorted(
            (r.name, r.schema) for g in eng.groups for r in g.rules
            if r.kind == "recording" and r.schema))

    def _promql_lint(self, engine, qs, query: str):
        """promlint on a user query: findings ride the response
        ``warnings`` array; ``&lint=strict`` turns error-severity
        findings into a 400 with structured diagnostics;
        ``&lint=off`` skips. Returns None to proceed, or a (code,
        payload) rejection."""
        mode = (self._param(qs, "lint", "") or "").lower()
        if mode == "off":
            return None
        diags = _lint_memo(query, self._lint_schema_items())
        if not diags:
            return None
        if mode == "strict":
            errs = [d for d in diags if d.severity == "error"]
            if errs:
                out = prom_json.error(
                    "promlint: " + "; ".join(
                        f"[{d.rule}] {d.message}" for d in errs),
                    "bad_data")
                out["lint"] = [
                    {"rule": d.rule, "message": d.message,
                     "pos": d.pos, "end": d.end,
                     "severity": d.severity} for d in diags]
                return 400, out
        engine.stats.warnings.extend(
            f"promlint: {d.render()}" for d in diags)
        return None

    def _query_range(self, engine, qs, ds: str, tctx=None):
        """One range query under the request's trace: the one the HTTP
        handler started before the admission gate (``_handle``), or for
        a peer hop one recorded under the caller's context. Its ``query``
        span holds parse, plan, execute and encode. The tail-retention
        decision is made here, once per request. An ``&explain=trace``
        payload is built before the response is written, so it holds the
        ``admission-wait`` span but not ``request`` or ``respond``,
        which close with the write."""
        import time as _time
        query = self._param(qs, "query")
        if not query:
            raise QueryError("missing query parameter")
        start = int(float(self._param(qs, "start", "0")))
        end = int(float(self._param(qs, "end", "0")))
        step = int(float(self._param(qs, "step", "10")))
        if end < start:
            raise QueryError("end < start")
        # tracing: a propagated context (peer hop) is always honored;
        # fresh requests sample per tracer policy; &explain=trace forces
        # a trace for this one request and inlines it in the response;
        # &explain=analyze extends it with per-stage device stats
        # (executable identity and cost, batcher occupancy, cache
        # dispositions, shed decisions: obs/devprof.py)
        explain = self._param(qs, "explain")
        explain_trace = explain in ("trace", "analyze")
        tr = self.tracer.start(tctx) if tctx is not None \
            else obs_trace.current_trace()
        entry = self.inflight.register(
            query, ds, kind="range",
            trace_id=tr.trace_id if tr is not None else None)
        stages: Dict[str, object] = {}
        t0 = _time.perf_counter()
        code = 0
        try:
            with obs_trace.activate(tr):
                with obs_trace.span("query", query=query, dataset=ds,
                                    node=self.node_id or ""):
                    code, payload = self._query_range_stages(
                        engine, qs, ds, query, start, end, step, entry,
                        stages,
                        force_dict=tctx is not None or explain_trace)
            if tr is not None and isinstance(payload, dict):
                if tctx is not None:
                    # peer hop: ship the local spans back; the entry
                    # node's recorder stitches them into ONE trace
                    payload["trace_spans"] = tr.spans_json()
                else:
                    if explain_trace:
                        payload["trace"] = tr.to_json()
                    if explain == "analyze":
                        payload["analyze"] = self._build_analyze(
                            tr, stages)
            return code, payload
        finally:
            # tail retention runs HERE so every exit path (success,
            # QueryError, shed, crash) decides the trace's fate exactly
            # once, with the outcome in hand
            total_s = _time.perf_counter() - t0
            self.inflight.unregister(entry)
            tr = self._finish_request_trace(
                tr, tctx, code, total_s, stages, force=explain_trace)
            obs_metrics.observe(
                "filodb_query_latency_seconds", _QLAT_HELP, total_s,
                trace_id=tr.trace_id if tr is not None else None)
            self._maybe_slow_log(total_s, query, ds, "range", engine,
                                 stages, tr)

    def _query_range_stages(self, engine, qs, ds, query, start, end,
                            step, entry, stages, force_dict=False):
        """The staged range-query path: parse (plan cache) ->
        materialize -> execute -> encode, with per-stage spans, the
        in-flight registry's stage pointer, and the ``stages``
        breakdown the slow-query log records. ``force_dict`` routes the
        encode off the pre-encoded fast path so trace keys can attach —
        only peer hops (``trace_spans`` rides the envelope) and explain
        requests need it; a plain request with a pending tail-sampling
        trace keeps the byte fast path."""
        import time as _time
        t0 = _time.perf_counter()
        self.inflight.stage(entry, "parse")
        with obs_trace.span("parse") as sp:
            plan = self.plan_cache.lookup(ds, query, start * 1000,
                                          step * 1000, end * 1000)
            cached = plan is not None
            if plan is None:
                plan = parse_query_range(query,
                                         TimeStepParams(start, step, end))
                self.plan_cache.store(ds, query, start * 1000,
                                      step * 1000, end * 1000, plan)
            pc_state = "hit" if cached else \
                ("miss" if self.plan_cache.enabled else "off")
            sp.tag(plan_cache=pc_state)
        # promlint semantic diagnostics on the user query: warnings in
        # the response envelope; &lint=strict -> 400 with diagnostics
        lint_out = self._promql_lint(engine, qs, query)
        if lint_out is not None:
            return lint_out
        if self._param(qs, "explain") == "analyze":
            # QoS cross-check surface: the static cost lattice that must
            # upper-bound estimate_cost's admission price
            from filodb_tpu_torch.promql import semant as _semant
            stages["staticCostBound"] = _semant.static_cost_bound(
                plan, getattr(engine, "shards", ()),
                metering=getattr(engine, "metering", None)).to_json()
        # cost-based tenant admission (query/qos.py): price the parsed
        # plan BEFORE any execution and charge the tenant's token
        # bucket; an over-budget query walks the degrade ladder
        # (stale-cache -> downsample -> partial) and only 429s when no
        # degraded answer exists.
        out = self._charge_or_shed(engine, qs, ds, query, plan,
                                   start, end, step, stages)
        if out is not None:
            return out
        t1 = _time.perf_counter()
        self.inflight.stage(entry, "plan")
        bypass = (self._param(qs, "cache", "")
                  or "").lower() in ("false", "0", "no")
        with obs_trace.span("plan"):
            # results cache: split the request into the cached extent
            # and the uncovered spans — only the latter materialize
            # (tail-only recomputation; a full hit materializes nothing)
            ses = self.result_cache.begin(
                engine, ds, query, plan, start * 1000, step * 1000,
                end * 1000, bypass=bypass)
            exs = [engine.materialize(p) for p in ses.plans]
        ex_label = type(exs[-1]).__name__ if exs else "ResultCacheHit"
        t2 = _time.perf_counter()
        self.inflight.stage(entry, "execute")
        with obs_trace.span("execute", plan=ex_label) as _esp:
            res = ses.finish(engine, [ex.execute() for ex in exs])
            _esp.tag(result_cache=ses.state,
                     cached_steps=ses.cached_steps)
        t3 = _time.perf_counter()
        stages["parseMs"] = round((t1 - t0) * 1000, 3)
        stages["planMs"] = round((t2 - t1) * 1000, 3)
        stages["execMs"] = round((t3 - t2) * 1000, 3)
        stages["planCache"] = pc_state
        stages["resultCache"] = ses.state
        if isinstance(res, ScalarResult):
            return 200, prom_json.scalar(res, instant=False)
        stats_json = self._query_stats(engine, res)
        stats_json["timings"] = {
            "parseMs": stages["parseMs"],
            "planMs": stages["planMs"],
            "execMs": stages["execMs"],
            "plan": ex_label,
            "planCache": pc_state,
            "resultCache": ses.state,
        }
        self.inflight.stage(entry, "encode")
        hist_wire = bool(self._param(qs, "hist-wire"))
        if isinstance(res, GridResult) and not hist_wire \
                and not res.is_hist() and not force_dict:
            # serving fast path: bulk matrix rows encode straight to
            # JSON bytes (memoized ts/value fragments), skipping the
            # dict tree + json.dumps walk
            st = engine.stats
            warnings = list(getattr(st, "warnings", ()) or ())
            warnings.extend(res.warnings)
            partial = bool(getattr(st, "partial", False) or res.partial)
            with obs_trace.span("encode"):
                out = prom_json.matrix_bytes(
                    res, stats_json, warnings=warnings, partial=partial,
                    rows_memo=ses.encode_memo())
            stages["encodeMs"] = round(
                (_time.perf_counter() - t3) * 1000, 3)
            return 200, out
        with obs_trace.span("encode"):
            out = prom_json.matrix(res, hist_wire=hist_wire)
            out["stats"] = stats_json
            prom_json.attach_degraded(out, res, engine.stats)
        stages["encodeMs"] = round((_time.perf_counter() - t3) * 1000, 3)
        return 200, out

    def _finish_request_trace(self, tr, tctx, code: int, total_s: float,
                              stages: Dict, force: bool = False):
        """The tail-retention decision for one finished request (called
        from the query paths' ``finally``): errors (exception in
        flight or a 4xx/5xx answer), QoS-shed/degraded rungs, and
        latency at/above the slow-query threshold always retain the
        pending trace; the rest keep the start-time sampling coin.
        Returns the trace iff it was retained (i.e. its id resolves in
        ``/debug/traces``) — callers link slowlog records and latency
        exemplars only to that. Peer hops pass through: the entry node
        owns retention, and the forwarded id still links the stitched
        entry-node trace."""
        if tr is None:
            return None
        if tctx is not None:
            return tr
        err = sys.exc_info()[0] is not None or code >= 400
        shed = bool(stages.get("qosShed"))
        will_log = (self.slow_log.enabled
                    and total_s * 1000.0 >= self.slow_log.threshold_ms)
        retained = self.tracer.finish_request(
            tr, error=err, shed=shed, duration_ms=total_s * 1000.0,
            force=force or will_log)
        return tr if retained else None

    def _maybe_slow_log(self, total_s: float, query: str, ds: str,
                        kind: str, engine, stages: Dict, tr) -> None:
        """Build + record the structured slow-query record (only on the
        slow path — fast queries pay one float compare)."""
        if not self.slow_log.enabled \
                or total_s * 1000 < self.slow_log.threshold_ms:
            return
        st = getattr(engine, "stats", None)
        rec = {
            "query": query, "dataset": ds, "kind": kind,
            "stages": dict(stages),
            "shards": sorted(
                int(n) for s in getattr(engine, "shards", ())
                for n in (s.shard_num if isinstance(
                    getattr(s, "shard_num", None), tuple)
                    else (getattr(s, "shard_num", -1),))),
            "seriesScanned": getattr(st, "series_scanned", 0),
            "samplesScanned": getattr(st, "samples_scanned", 0),
            "partial": bool(getattr(st, "partial", False)),
            "warnings": list(getattr(st, "warnings", ()) or ()),
        }
        if tr is not None:
            rec["trace_id"] = tr.trace_id
        self.slow_log.maybe_record(total_s * 1000, rec)

    def _query_instant(self, engine, qs, ds: str, tctx=None):
        import time as _time
        query = self._param(qs, "query")
        if not query:
            raise QueryError("missing query parameter")
        time_s = int(float(self._param(qs, "time", "0")))
        explain = self._param(qs, "explain")
        explain_trace = explain in ("trace", "analyze")
        # the handler's trace, or a peer hop's (as _query_range)
        tr = self.tracer.start(tctx) if tctx is not None \
            else obs_trace.current_trace()
        entry = self.inflight.register(
            query, ds, kind="instant",
            trace_id=tr.trace_id if tr is not None else None)
        stages: Dict[str, object] = {}
        t0 = _time.perf_counter()
        code = 0
        try:
            with obs_trace.activate(tr):
                with obs_trace.span("query", query=query, dataset=ds,
                                    node=self.node_id or ""):
                    code, payload = self._query_instant_stages(
                        engine, qs, ds, query, time_s, entry, stages)
            if tr is not None and isinstance(payload, dict):
                if tctx is not None:
                    payload["trace_spans"] = tr.spans_json()
                else:
                    if explain_trace:
                        payload["trace"] = tr.to_json()
                    if explain == "analyze":
                        payload["analyze"] = self._build_analyze(
                            tr, stages)
            return code, payload
        finally:
            total_s = _time.perf_counter() - t0
            self.inflight.unregister(entry)
            tr = self._finish_request_trace(
                tr, tctx, code, total_s, stages, force=explain_trace)
            obs_metrics.observe(
                "filodb_query_latency_seconds", _QLAT_HELP, total_s,
                trace_id=tr.trace_id if tr is not None else None)
            self._maybe_slow_log(total_s, query, ds, "instant", engine,
                                 stages, tr)

    def _query_instant_stages(self, engine, qs, ds, query, time_s,
                              entry, stages):
        import time as _time
        t0 = _time.perf_counter()
        self.inflight.stage(entry, "parse")
        # instant queries cache under step=0 (start == end == time)
        with obs_trace.span("parse"):
            plan = self.plan_cache.lookup(ds, query, time_s * 1000, 0,
                                          time_s * 1000)
            if plan is None:
                plan = parse_query(query, time_s)
                self.plan_cache.store(ds, query, time_s * 1000, 0,
                                      time_s * 1000, plan)
        lint_out = self._promql_lint(engine, qs, query)
        if lint_out is not None:
            return lint_out
        if self._param(qs, "explain") == "analyze":
            from filodb_tpu_torch.promql import semant as _semant
            stages["staticCostBound"] = _semant.static_cost_bound(
                plan, getattr(engine, "shards", ()),
                metering=getattr(engine, "metering", None)).to_json()
        # cost admission: instant queries charge too, but there is no
        # range to stale-serve/coarsen/trim — over budget means 429
        # (step=0 makes the ladder decline)
        out = self._charge_or_shed(engine, qs, ds, query, plan,
                                   time_s, time_s, 0, stages)
        if out is not None:
            return out
        t1 = _time.perf_counter()
        self.inflight.stage(entry, "execute")
        with obs_trace.span("execute"):
            res = engine.execute(plan)
        t2 = _time.perf_counter()
        stages["parseMs"] = round((t1 - t0) * 1000, 3)
        stages["execMs"] = round((t2 - t1) * 1000, 3)
        if isinstance(res, ScalarResult):
            return 200, prom_json.scalar(res, instant=True)
        self.inflight.stage(entry, "encode")
        with obs_trace.span("encode"):
            out = prom_json.vector(res)
            out["stats"] = self._query_stats(engine, res)
            prom_json.attach_degraded(out, res, engine.stats)
        stages["encodeMs"] = round((_time.perf_counter() - t2) * 1000, 3)
        return 200, out

    def _build_analyze(self, tr, stages: Dict) -> Dict:
        """The ``&explain=analyze`` envelope: the traced spans resolve to
        per-stage device stats (executable identity and disposition per
        dispatch, analytic FLOPs and bytes computed on demand and kept per
        executable, batcher occupancy at dispatch), cache dispositions and
        shed decisions from the stage breakdown."""
        batcher_stats = None
        batcher = getattr(self.backend, "batcher", None) \
            if self.backend is not None else None
        if batcher is not None:
            bs = batcher.stats.snapshot()
            batcher_stats = {"enabled": batcher.enabled,
                             "occupancy_avg": bs["occupancy_avg"],
                             "occupancy_max": bs["occupancy_max"],
                             "batches": bs["batches"],
                             "by_priority": bs["by_priority"]}
        qctx = qos.current()
        qos_info = None
        if qctx is not None:
            qos_info = {"tenant": qctx.tenant,
                        "priority": qos.PRIORITY_NAMES.get(
                            qctx.priority, str(qctx.priority)),
                        "degraded": qctx.degraded,
                        "forced": qctx.forced}
            if stages.get("qosShed"):
                qos_info["shed"] = stages["qosShed"]
        return obs_devprof.analyze_payload(
            tr.spans_json(), stages, batcher_stats=batcher_stats,
            qos_info=qos_info,
            residency=lint_capacity.residency_snapshot())

    def _debug_traces(self, qs):
        """GET /debug/traces: recent finished traces (summaries), or one
        full trace via ?id=<trace_id>."""
        tid = self._param(qs, "id")
        if tid:
            tr = self.tracer.get(tid)
            if tr is None:
                return {"status": "error", "errorType": "not_found",
                        "error": f"no trace {tid} in the ring buffer"}
            return {"status": "success", "data": tr.to_json()}
        limit = int(self._param(qs, "limit", "50") or 50)
        full = (self._param(qs, "full", "") or "").lower() in \
            ("true", "1", "yes")
        traces = self.tracer.recent(limit)
        if full:
            data = [t.to_json() for t in traces]
        else:
            data = [{"trace_id": t.to_json()["trace_id"],
                     "num_spans": t.to_json()["num_spans"],
                     "duration_us": t.to_json()["duration_us"]}
                    for t in traces]
        return {"status": "success",
                "summary": self.tracer.snapshot(), "data": data}

    def _debug_profile(self, qs):
        """GET /debug/profile?seconds=N[&format=folded|json]: the sampling
        profiler's aggregate. ``seconds>0`` profiles a window (delta of
        the running sampler, or an inline burst when the sampler daemon
        is off: the handler thread blocks for the window, clamped);
        ``seconds=0`` reads the cumulative aggregate. ``format=folded``
        answers flamegraph-ready folded text."""
        prof = self.profiler
        if prof is None:
            return 404, {"status": "error", "errorType": "unavailable",
                         "error": "profiler not configured "
                                  "(--profiler-enabled)"}
        try:
            seconds = float(self._param(qs, "seconds", "0") or 0)
        except ValueError:
            raise QueryError("seconds must be a number")
        if seconds > 0:
            folded, selfs = (prof.window(seconds) if prof.running
                             else prof.sample_burst(seconds))
        else:
            folded, selfs = prof.tables()
        fmt = (self._param(qs, "format", "json") or "json").lower()
        if fmt == "folded":
            return 200, prof.folded_text(folded)
        return 200, {"status": "success",
                     "data": prof.report(folded, selfs,
                                         window_s=seconds or None)}

    @staticmethod
    def _query_stats(engine, res) -> Dict:
        """Execution stats in the response (QueryStats threaded through
        results, core/query/QueryContext.scala; Prom &stats=all shape)."""
        st = engine.stats
        nbytes = 0
        if isinstance(res, GridResult):
            nbytes = int(res.values.nbytes)
            if res.hist_values is not None:
                nbytes += int(res.hist_values.nbytes)
        return {"seriesScanned": st.series_scanned,
                "samplesScanned": st.samples_scanned,
                "resultBytes": nbytes}

    def _time_range(self, qs):
        start = int(float(self._param(qs, "start", "0"))) * 1000
        end_raw = self._param(qs, "end")
        end = (int(float(end_raw)) * 1000 if end_raw is not None
               else 1 << 62)
        return start, end

    def _labels(self, engine, qs, ds="timeseries"):
        # Prometheus semantics: result is the UNION over all match[]
        # selectors (none -> all series).
        start, end = self._time_range(qs)
        out: set = set()
        for sel in qs.get("match[]", []) or [None]:
            filters = selector_to_filters(sel) if sel else ()
            out.update(engine.execute(lp.LabelNames(list(filters),
                                                    start, end)))
        if self.peers:
            out |= self._peer_metadata_union(ds, "labels", qs)
        return 200, prom_json.success(sorted(out))

    def _label_values(self, engine, name, qs, ds="timeseries"):
        start, end = self._time_range(qs)
        out: set = set()
        for sel in qs.get("match[]", []) or [None]:
            filters = selector_to_filters(sel) if sel else ()
            out.update(engine.execute(lp.LabelValues(name, list(filters),
                                                     start, end)))
        if self.peers:
            out |= self._peer_metadata_union(ds, f"label/{name}/values",
                                             qs)
        return 200, prom_json.success(sorted(out))

    def _series(self, engine, qs, ds="timeseries"):
        start, end = self._time_range(qs)
        out = []
        seen = set()
        for sel in qs.get("match[]", []):
            filters = selector_to_filters(sel)
            for labels in engine.execute(
                    lp.SeriesKeysByFilters(list(filters), start, end)):
                key = frozenset(labels.items())
                if key not in seen:
                    seen.add(key)
                    out.append(prom_json._metric(labels))
        if self.peers:
            for item in self._peer_metadata_union(ds, "series", qs):
                labels = dict(item)
                key = frozenset(labels.items())
                if key not in seen:
                    seen.add(key)
                    out.append(labels)
        return 200, prom_json.success(out)

    def _cluster_status(self, ds):
        """ClusterApiRoute status (ShardMapper snapshot)."""
        if self.shard_mapper is None:
            shards = self.shards_by_dataset.get(ds, [])
            states = [{"shard": i, "status": "Active"}
                      for i in range(len(shards))]
        else:
            states = [{"shard": i,
                       "status": self.shard_mapper.status(i).value,
                       "address": self.shard_mapper.node_of(i)}
                      for i in range(self.shard_mapper.num_shards)]
        return prom_json.success(states)

    def _cardinality(self, ds: str, qs: Dict, local: bool = False):
        """GET /api/v1/cardinality/{ds}?prefix=ws,ns&depth=N — per-prefix
        series counts from the cardinality trackers (TsCardinalities plan;
        reference TsCardExec + TenantIngestionMetering surface)."""
        shards = self.shards_by_dataset.get(ds)
        if shards is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        raw_prefix = self._param(qs, "prefix", "") or ""
        prefix = tuple(p for p in raw_prefix.split(",") if p)
        try:
            depth = int(self._param(qs, "depth",
                                    str(min(len(prefix) + 1, 3))))
        except ValueError:
            raise QueryError("depth must be an integer")
        if depth < len(prefix):
            raise QueryError("depth must be >= prefix length")
        recs = QueryEngine(shards).execute(
            lp.TsCardinalities(prefix, depth))
        if self.peers and not local:
            # cross-node merge: peers answer their local counts
            # (TsCardReduceExec scatter-gather)
            from filodb_tpu_torch.core.cardinality import (
                CardinalityRecord, merge_records)
            remote = self._peer_cardinality(ds, qs)
            recs = merge_records([recs] + [[
                CardinalityRecord(tuple(d["prefix"]), d["tsCount"],
                                  d["activeTsCount"], d["childrenCount"],
                                  d["childrenQuota"])
                for d in batch] for batch in remote])
        return 200, prom_json.success([r.to_json() for r in recs])

    def _peer_cardinality(self, ds: str, qs: Dict) -> List[List[Dict]]:
        targets = self._live_peer_urls(
            "{base}/api/v1/cardinality-local/%s" % ds, qs)
        return [p["data"] for p in self._fanout(targets)]

    # -- cluster plane ----------------------------------------------------
    def _raw_dispatch(self, ds: str, body: Optional[Dict], tctx=None):
        """POST /api/v1/raw/{ds}: the leaf-dispatch endpoint peers call to
        read raw series from THIS node's shards (PlanDispatcher.scala:21 —
        the entry node evaluates the plan over the merged series).
        ``tctx`` is the caller's propagated trace context: spans
        recorded here ride back in ``trace_spans`` for the entry node
        to stitch."""
        from filodb_tpu_torch.parallel.cluster import (series_to_wire,
                                                       wire_to_filters)
        from filodb_tpu_torch.query.model import QueryStats
        if body is None:
            return 400, prom_json.error("missing JSON body")
        # deadline propagation: the caller (an entry node mid-query)
        # forwards its REMAINING budget; this leaf inherits it instead
        # of running unbounded while the entry node has long timed out
        deadline = None
        if body.get("timeout_s") is not None:
            try:
                deadline = Deadline.after(
                    min(float(body["timeout_s"]), self.query_timeout_s))
            except (TypeError, ValueError):
                deadline = None
        tr = self.tracer.start(tctx) if tctx is not None else None
        # tenant QoS budget inheritance on the JSON leaf plane: forced
        # charge (the entry node already made the admission decision)
        # + the leg's priority class for the batcher
        qctx = None
        if body.get("tenant"):
            qctx = qos.QosContext(tenant=str(body["tenant"]),
                                  priority=int(body.get("priority")
                                               or 0), forced=True)
            adm = self.admission
            if adm is not None and adm.budgets.enabled:
                adm.budgets.charge_forced(
                    qctx.tenant, qos.estimate_leaf_cost(
                        wire_to_filters(body.get("filters", [])),
                        self.shards_by_dataset.get(ds, ()),
                        int(body.get("start_ms") or 0),
                        int(body.get("end_ms") or 0)))
        with qos.activate(qctx), obs_trace.activate(tr):
            with obs_trace.span("peer-fetch-raw",
                                node=self.node_id or "", dataset=ds,
                                plane="http"):
                try:
                    series = self.leaf_select(
                        ds, wire_to_filters(body.get("filters", [])),
                        int(body["start_ms"]), int(body["end_ms"]),
                        body.get("column"), body.get("shards"),
                        span_snap=bool(body.get("full", True)),
                        stats=QueryStats(), deadline=deadline)
                except StaleRoutingError as e:
                    # HTTP 200 + error envelope (not a 4xx): the
                    # caller must read the owners hint, and a non-2xx
                    # would surface as a retryable transport error
                    return 200, {
                        "status": "error",
                        "errorType": "stale_routing", "error": str(e),
                        "owners": {str(k): v
                                   for k, v in e.owners.items()},
                        "topo_epoch": e.epoch}
        if series is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        out = {"status": "success", "data": series_to_wire(series)}
        # every peer response carries the responder's topology epoch:
        # the entry node can cross-check its routing freshness
        if self.shard_mapper is not None \
                and hasattr(self.shard_mapper, "topology_epoch"):
            out["topo_epoch"] = self.shard_mapper.topology_epoch
        if tr is not None:
            out["trace_spans"] = tr.spans_json()
        return 200, out

    def leaf_select(self, ds: str, filters, start_ms: int, end_ms: int,
                    column, want_shards, span_snap: bool = True,
                    stats=None, deadline: Optional[Deadline] = None):
        """Shared leaf-dispatch selection (HTTP raw endpoint + the gRPC
        FetchRaw service): span-bounded reads with node-scoped snapshot
        keys, so the payload scales with the query span, not retention
        (SerializedRangeVector semantics, RangeVector.scala:452).
        ``deadline`` carries the entry node's forwarded remaining
        budget; selection checks it per shard and fails fast. A wanted
        shard that is NOT served here raises StaleRoutingError (with
        this node's owner map) instead of silently answering for a
        subset — the caller's routing lags a handoff and must not hand
        an incomplete result to its client."""
        from filodb_tpu_torch.query.engine import (select_raw_series,
                                                   select_span_series)
        shards = self.shards_by_dataset.get(ds)
        if shards is None:
            return None
        by_num = {getattr(s, "shard_num", i): s
                  for i, s in enumerate(shards)}
        if want_shards is not None:
            missing = [int(n) for n in want_shards if n not in by_num]
            if missing:
                self.stale_routing_bounces += 1
                owners = {}
                if self.shard_mapper is not None:
                    owners = {n: self.shard_mapper.node_of(n)
                              for n in missing}
                raise StaleRoutingError(
                    owners=owners,
                    epoch=getattr(self.shard_mapper, "topology_epoch",
                                  0) if self.shard_mapper is not None
                    else 0,
                    node=self.node_id or "",
                    detail=f"shards {sorted(missing)} are not served "
                           f"here")
        subset = [by_num[n] for n in want_shards if n in by_num] \
            if want_shards is not None else shards
        if span_snap:
            return select_span_series(
                subset, filters, start_ms, end_ms, column, stats,
                limits=self.query_limits, node_id=self.node_id or "",
                ds=ds, deadline=deadline)
        return select_raw_series(
            subset, filters, start_ms, end_ms, column, stats,
            full=False, limits=self.query_limits, deadline=deadline)

    def _live_peer_urls(self, path_fmt: str, qs: Dict) -> List[str]:
        """URLs for peers whose shards are still queryable (dead peers are
        skipped — the FailureDetector already marked them DOWN)."""
        targets = []
        for node, base in self.peers.items():
            if self.shard_mapper is not None:
                shards = self.shard_mapper.shards_for_node(node)
                if shards and not self.shard_mapper.active_shards(shards):
                    continue
            targets.append(path_fmt.format(base=base.rstrip("/"))
                           + "?" + urllib.parse.urlencode(qs, doseq=True))
        return targets

    def _fanout(self, targets: List[str]) -> List[Dict]:
        """Concurrent GETs; returns successful payloads only (down peers
        yield partial results, matching the query path's semantics).
        Concurrency is ``fanout_workers`` (knob ``peer-fanout-workers``,
        auto-sized from the core count; surfaced in /metrics) — the old
        hard-coded cap of 8 serialized metadata fan-out on wide
        clusters."""
        import urllib.request as ureq
        from concurrent.futures import ThreadPoolExecutor
        if not targets:
            return []

        def fetch(url):
            try:
                with ureq.urlopen(url, timeout=5) as r:
                    payload = json.loads(r.read())
                if payload.get("status") == "success":
                    return payload
            except (OSError, ValueError):
                pass
            return None

        with ThreadPoolExecutor(
                max_workers=min(self.fanout_workers,
                                len(targets))) as ex:
            return [p for p in ex.map(fetch, targets) if p]

    def _peer_metadata_union(self, ds: str, rest: str, qs: Dict) -> set:
        """Fan a labels/label-values request out to peers and union the
        results (metadata scatter-gather; MetadataRemoteExec
        equivalent)."""
        out: set = set()
        if qs.get("__local__"):
            return out
        q = dict(qs)
        q["__local__"] = ["1"]
        targets = self._live_peer_urls(
            "{base}/promql/%s/api/v1/%s" % (ds, rest), q)
        for payload in self._fanout(targets):
            out.update(tuple(sorted(d.items())) if isinstance(d, dict)
                       else d for d in payload["data"])
        return out

    # -- Prometheus remote-read -------------------------------------------
    def _remote_read(self, ds: str, body_raw: bytes):
        """POST /promql/{ds}/api/v1/read: snappy(ReadRequest protobuf) ->
        snappy(ReadResponse) (remote-storage.proto;
        PrometheusApiRoute.scala:129)."""
        from filodb_tpu_torch.core.index import ColumnFilter
        from filodb_tpu_torch.http import remote_read as rr
        from filodb_tpu_torch.query.engine import select_raw_series
        from filodb_tpu_torch.query.model import QueryStats
        from filodb_tpu_torch.query import logical as lp2
        shards = self.shards_by_dataset.get(ds)
        if shards is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        if not body_raw:
            return 400, prom_json.error("missing remote-read body")
        try:
            queries = rr.decode_read_request(
                rr.snappy_decompress(body_raw))
        except (ValueError, IndexError) as e:
            raise QueryError(f"bad remote-read request: {e}")
        # resolve through the planner so cluster peers / buddy replicas
        # serve their shards — same coverage as /query_range
        planner = QueryPlanner(shards, shard_mapper=self.shard_mapper,
                               spread=self.spread,
                               spread_provider=self.spread_provider,
                               limits=self.query_limits,
                               node_id=self.node_id, peers=self.peers,
                               buddies=self.buddies, dataset=ds,
                               resilience=self.resilience,
                               deadline=Deadline.after(
                                   self.query_timeout_s))
        results = []
        for q in queries:
            # Prometheus clients send __name__; our index stores the
            # metric under the schema's metric column (_metric_), the
            # same mapping the PromQL parser applies
            filters = [ColumnFilter(
                "_metric_" if n == "__name__" else n, op, v)
                for n, op, v in q["matchers"]]
            plan = lp2.RawSeriesPlan(tuple(filters), q["start_ms"],
                                     q["end_ms"])
            shard_objs = planner._resolve_shards(plan)
            # federated workspaces: matchers pinning _ws_ to a partition
            # another cluster owns read that cluster's raw endpoint (the
            # same coverage /query_range gets from partition routing)
            ws = [f.value for f in filters
                  if f.label == "_ws_" and f.op == "eq"]
            if ws and self.partitions:
                url = self.partitions.get(ws[0])
                if url and ws[0] not in self.local_partitions:
                    from filodb_tpu_torch.parallel.cluster import \
                        RemoteShardGroup
                    shard_objs = [RemoteShardGroup(
                        f"partition:{url}", url, ds, None)]
            series = select_raw_series(
                shard_objs, filters,
                q["start_ms"], q["end_ms"], None,
                QueryStats(), limits=self.query_limits)
            out = []
            for s in series:
                if s.values.ndim != 1:
                    continue    # histograms have no remote-read shape
                samples = [(int(t), float(v))
                           for t, v in zip(s.ts, s.values)]
                # external label form: _metric_ -> __name__ (same
                # mapping as the JSON path)
                out.append((prom_json._metric(dict(s.labels)), samples))
            results.append(out)
        return 200, rr.snappy_compress(rr.encode_read_response(results))

    _METRIC_HELP = {
        "filodb_shard_status": "Shard FSM status (1 per shard; labels "
                               "carry status/node)",
        "filodb_cardinality_total_series": "Total series tracked by the "
                                           "shard's cardinality tracker",
        "filodb_cardinality_active_series": "Actively-ingesting series",
        "filodb_tile_cache_entries": "Device tile-cache entries",
        "filodb_tile_builds_total": "Device tile (re)builds",
        "filodb_tile_cache_hits_total": "Device tile-cache hits",
        "filodb_exec_cache_hits_total":
            "Device dispatches of a dispatch key seen before",
        "filodb_exec_cache_misses_total":
            "First dispatches of a dispatch key",
        "filodb_exec_cache_entries": "Distinct dispatch keys",
        "filodb_batcher_enabled": "Micro-batcher admission on/off",
        "filodb_batcher_batches_total": "Device dispatches issued",
        "filodb_batcher_queries_total": "Queries admitted",
        "filodb_batcher_batched_queries_total":
            "Queries that shared a batch (size >= 2)",
        "filodb_batcher_occupancy_avg": "Mean batch size",
        "filodb_batcher_occupancy_max": "Max batch size seen",
        "filodb_batcher_gather_wait_ms_total":
            "Total residual gather-window wait",
        "filodb_batcher_priority_queries_total":
            "Batcher dispatches by priority class (tenant QoS)",
        "filodb_plan_cache_entries": "Parsed-plan LRU entries",
        "filodb_plan_cache_hits_total": "Plan-cache hits",
        "filodb_plan_cache_misses_total": "Plan-cache misses",
        "filodb_plan_cache_rebases_total":
            "Cached plans rebased onto a new range",
        "filodb_plan_cache_invalidations_total":
            "Topology/schema invalidations",
        "filodb_result_cache_entries": "Results-cache extents resident",
        "filodb_result_cache_bytes": "Results-cache bytes resident "
                                     "(byte-accounted LRU)",
        "filodb_result_cache_hits_total":
            "Range queries answered entirely from cached extents",
        "filodb_result_cache_partial_hits_total":
            "Range queries stitched from a cached extent + a "
            "recomputed head/tail",
        "filodb_result_cache_misses_total": "Results-cache misses",
        "filodb_result_cache_stitches_total":
            "Span evaluations stitched into cached extents",
        "filodb_result_cache_churn_recomputes_total":
            "Series churn forced a full fresh recompute",
        "filodb_result_cache_bypassed_total":
            "Queries carrying the &cache=false escape hatch",
        "filodb_result_cache_degraded_skips_total":
            "Partial/degraded results refused admission to the cache",
        "filodb_result_cache_evictions_total":
            "Extents evicted by the byte-budget LRU",
        "filodb_result_cache_invalidations_total":
            "Topology/schema invalidations (shared with the plan cache)",
        "filodb_result_cache_watermark_invalidations_total":
            "Extents dropped on ingest-watermark regression "
            "(replay/recovery)",
        "filodb_result_cache_backfill_invalidations_total":
            "Extents dropped on shard backfill-epoch change (a new "
            "series ingested below the watermark)",
        "filodb_result_cache_cached_steps_served_total":
            "Steps served from cached extents",
        "filodb_result_cache_computed_steps_served_total":
            "Steps recomputed through the pipeline",
        "filodb_result_cache_stale_serves_total":
            "Brownout stale-cache rung: extents served past the "
            "freshness horizon to an over-budget tenant / saturated "
            "host",
        "filodb_decode_cache_bytes":
            "Per-shard decode/merge cache bytes (bounded by "
            "decode-cache-mb)",
        "filodb_ingest_watermark_ms":
            "Per-shard settled-time bound (ms): min over per-"
            "partition last timestamps; the results cache's "
            "freshness horizon input",
        "filodb_topology_epoch":
            "Monotone topology epoch (bumped on every shard-ownership "
            "change; plan/results caches invalidate on it)",
        "filodb_admission_max_inflight":
            "Admission slots (host bound)",
        "filodb_admission_inflight":
            "Queries currently holding an admission slot",
        "filodb_admission_wait_timeouts_total":
            "Bounded admission waits that timed out (slot never "
            "freed within admission-wait-s)",
        "filodb_admission_rejected_total":
            "Queries answered 429 at the saturation gate",
        "filodb_tenant_budget_remaining":
            "Per-tenant token-bucket balance (cost units; negative = "
            "debt from forced charges)",
        "filodb_tenant_budget_rate":
            "Per-tenant budget refill rate (cost units/s)",
        "filodb_tenant_cost_charged_total":
            "Estimated cost units charged to the tenant (admitted + "
            "forced)",
        "filodb_tenant_admitted_total":
            "Queries the tenant's budget admitted cleanly",
        "filodb_tenant_throttled_total":
            "Budget charges refused (query entered the degrade "
            "ladder)",
        "filodb_tenant_forced_charges_total":
            "Charges of reserved internal tenants (never shed)",
        "filodb_tenant_degraded_total":
            "Degraded answers served, by ladder rung "
            "(stale/downsample/partial)",
        "filodb_tenant_rejected_total":
            "Tenant queries answered 429 (over budget, no degraded "
            "answer existed)",
        "filodb_grpc_rpcs_served_total": "gRPC query-service RPCs served",
        "filodb_grpc_plane_fallbacks_total":
            "Leaf fetches and pushdowns of this node that fell back from "
            "the gRPC plane to the HTTP JSON plane, by peer",
        "filodb_breaker_state": "Per-peer circuit-breaker state "
                                "(1 per peer; state label)",
        "filodb_shard_handoff_started_total":
            "Planned shard handoffs started (drain + hand-back)",
        "filodb_shard_handoff_completed_total":
            "Planned shard handoffs completed (ownership flipped, "
            "local copy released)",
        "filodb_shard_handoff_failed_total":
            "Planned shard handoffs rolled back to the draining owner",
        "filodb_shard_adoptions_total":
            "Shards adopted by this node (kind=planned handoff / "
            "kind=crash reassignment)",
        "filodb_shard_releases_total":
            "Local shard copies released (handoff completion or "
            "owner return)",
        "filodb_membership_draining":
            "1 while this node is draining its shards for a planned "
            "restart",
        "filodb_membership_incoming_shards":
            "Planned adoptions currently replaying on this node",
        "filodb_handback_failures_total":
            "Hand-back handoffs that exhausted their retries (shard "
            "stays on the temporary owner)",
        "filodb_stale_routing_bounces_total":
            "Peer requests bounced because they named shards this "
            "node no longer serves",
        "filodb_stale_routing_retries_total":
            "Queries re-materialized against fresh routing after a "
            "peer's stale-routing bounce",
        "filodb_detector_thread_wedged":
            "1 if the failure-detector monitor thread failed to exit "
            "on stop()",
        "filodb_peer_fanout_workers":
            "Metadata/cardinality peer fan-out concurrency "
            "(peer-fanout-workers knob; auto = host core count)",
        "filodb_worker_ordinal":
            "This process's worker ordinal in a supervisor deployment",
        "filodb_bus_events_published_total":
            "Control-plane events this worker published to the "
            "supervisor bus",
        "filodb_bus_events_applied_total":
            "Control-plane events this worker applied from the "
            "supervisor bus (topology/schema invalidations, "
            "watermark gossip, worker lifecycle hints)",
        "filodb_bus_reconnects_total":
            "Reconnects of this worker's bus client to the supervisor",
        "filodb_bus_connected":
            "1 while the worker's bus client is connected to the "
            "supervisor's control plane",
        "filodb_tenant_time_series_total": "Per-tenant series count",
        "filodb_tenant_time_series_active":
            "Per-tenant actively-ingesting series count",
        "filodb_tenant_metering_interval_seconds":
            "Configured tenant-metering snapshot interval",
        "filodb_tenant_metering_last_snapshot_age_seconds":
            "Seconds since the last tenant-metering snapshot",
        "filodb_tenant_metering_snapshots_total":
            "Tenant-metering snapshots taken",
        "filodb_traces_started_total": "Traces started on this node",
        "filodb_selfmon_alive":
            "1 while the self-monitoring loop thread is running",
        "filodb_selfmon_interval_seconds":
            "Configured self-monitoring collect+ingest interval",
        "filodb_traces_stored": "Finished traces in /debug/traces",
        "filodb_slow_queries_total": "Queries over the slow-query "
                                     "threshold",
        "filodb_inflight_queries": "Queries currently executing",
    }

    def _metrics_text(self, exemplars: bool = False) -> str:
        return self.build_exposition(exemplars=exemplars).render()

    def build_exposition(self, exemplars: bool = False
                         ) -> "obs_metrics.ExpositionBuilder":
        """Prometheus exposition — the Kamon-metrics surface
        (TimeSeriesShardStats, TimeSeriesShard.scala:41), accumulated
        into an :class:`~filodb_tpu_torch.obs.metrics.ExpositionBuilder`:
        one ``# HELP``/``# TYPE`` block per family, consistent
        label-value escaping, no duplicate series, and the global
        registry's counter/gauge/histogram families.

        The device backend contributes its tile cache and its
        micro-batcher (priorities included); eager PyTorch keeps no
        compiled-executable cache, so that family of the reference is
        absent."""
        import dataclasses as _dc

        b = obs_metrics.ExpositionBuilder()

        def emit(name, labels, value, mtype=None):
            fam = f"filodb_{name}"
            if mtype is None:
                mtype = "counter" if fam.endswith("_total") else "gauge"
            b.sample(fam, labels, value, mtype=mtype,
                     help=self._METRIC_HELP.get(
                         fam, f"FiloDB metric {fam}"))

        for ds, shards in self.shards_by_dataset.items():
            for shard in shards:
                st = getattr(shard, "stats", None)
                if st is None:
                    continue
                labels = {"dataset": ds,
                          "shard": str(getattr(shard, "shard_num", ""))}
                for f in _dc.fields(st):
                    emit(f.name, labels, getattr(st, f.name))
                if hasattr(shard, "decode_cache_bytes"):
                    emit("decode_cache_bytes", labels,
                         shard.decode_cache_bytes())
                wm = getattr(shard, "ingest_watermark_ms", None)
                if wm is not None:
                    emit("ingest_watermark_ms", labels, wm)
                tracker = getattr(shard, "card_tracker", None)
                if tracker is not None:
                    root = tracker.scan((), 0)
                    if root:
                        emit("cardinality_total_series", labels,
                             root[0].ts_count)
                        emit("cardinality_active_series", labels,
                             root[0].active_ts_count)
        if self.shard_mapper is not None:
            for i in range(self.shard_mapper.num_shards):
                emit("shard_status", {
                    "shard": str(i),
                    "status": self.shard_mapper.status(i).value,
                    "node": str(self.shard_mapper.node_of(i))}, 1)
            emit("topology_epoch", {},
                 self.shard_mapper.topology_epoch)
        if self.backend is not None:
            emit("tile_cache_entries", {}, len(self.backend._tile_cache))
            emit("tile_builds_total", {}, self.backend.tile_builds)
            emit("tile_cache_hits_total", {}, self.backend.tile_hits)
            # dispatch-key reuse (the reference's compiled-executable
            # reuse counters) and micro-batcher occupancy
            exec_stats = getattr(self.backend, "executable_cache_stats",
                                 None)
            if exec_stats is not None:
                st = exec_stats()
                emit("exec_cache_hits_total", {}, st["hits"])
                emit("exec_cache_misses_total", {}, st["misses"])
                emit("exec_cache_entries", {}, st["entries"])
            batcher = self.backend.batcher
            if batcher is not None:
                bs = batcher.stats.snapshot()
                emit("batcher_enabled", {}, 1 if batcher.enabled else 0)
                emit("batcher_batches_total", {}, bs["batches"])
                emit("batcher_queries_total", {}, bs["queries"])
                emit("batcher_batched_queries_total", {},
                     bs["batched_queries"])
                emit("batcher_occupancy_avg", {}, bs["occupancy_avg"])
                emit("batcher_occupancy_max", {}, bs["occupancy_max"])
                emit("batcher_gather_wait_ms_total", {},
                     bs["gather_wait_ms"])
                for cls, n in sorted(bs.get("by_priority",
                                            {}).items()):
                    emit("batcher_priority_queries_total",
                         {"class": cls}, n)
        pc = self.plan_cache.snapshot()
        emit("plan_cache_entries", {}, pc["entries"])
        emit("plan_cache_hits_total", {}, pc["hits"])
        emit("plan_cache_misses_total", {}, pc["misses"])
        emit("plan_cache_rebases_total", {}, pc["rebases"])
        emit("plan_cache_invalidations_total", {}, pc["invalidations"])
        for reason, n in sorted(
                pc.get("invalidations_by_reason", {}).items()):
            emit("plan_cache_invalidations_by_reason_total",
                 {"reason": reason}, n)
        rc = self.result_cache.snapshot()
        emit("result_cache_entries", {}, rc["entries"])
        emit("result_cache_bytes", {}, rc["bytes"])
        emit("result_cache_hits_total", {}, rc["hits"])
        emit("result_cache_partial_hits_total", {}, rc["partial_hits"])
        emit("result_cache_misses_total", {}, rc["misses"])
        emit("result_cache_stitches_total", {}, rc["stitches"])
        emit("result_cache_churn_recomputes_total", {},
             rc["churn_recomputes"])
        emit("result_cache_bypassed_total", {}, rc["bypassed"])
        emit("result_cache_degraded_skips_total", {},
             rc["degraded_skips"])
        emit("result_cache_evictions_total", {}, rc["evictions"])
        emit("result_cache_invalidations_total", {},
             rc["invalidations"])
        emit("result_cache_watermark_invalidations_total", {},
             rc["watermark_invalidations"])
        emit("result_cache_backfill_invalidations_total", {},
             rc["backfill_invalidations"])
        emit("result_cache_cached_steps_served_total", {},
             rc["cached_steps_served"])
        emit("result_cache_computed_steps_served_total", {},
             rc["computed_steps_served"])
        emit("result_cache_stale_serves_total", {},
             rc.get("stale_serves", 0))
        # tenant QoS: admission-gate counters + per-tenant budget
        # families
        adm = self.admission
        asnap = adm.snapshot()
        emit("admission_max_inflight", {}, asnap["max_inflight"])
        emit("admission_inflight", {}, asnap["inflight"])
        emit("admission_wait_timeouts_total", {}, asnap["wait_timeouts"])
        emit("admission_rejected_total", {}, asnap["slot_rejections"])
        for tenant, t in sorted(adm.budgets.snapshot().items()):
            lbl = {"tenant": tenant}
            if "remaining" in t:
                emit("tenant_budget_remaining", lbl, t["remaining"])
                emit("tenant_budget_rate", lbl, t["rate"])
                emit("tenant_cost_charged_total", lbl,
                     round(t["charged_total"], 3))
                emit("tenant_admitted_total", lbl, t["admitted"])
                emit("tenant_throttled_total", lbl, t["throttled"])
                emit("tenant_forced_charges_total", lbl,
                     t["forced_charges"])
            for rung, n in sorted(t.get("degraded", {}).items()):
                emit("tenant_degraded_total", {**lbl, "rung": rung}, n)
            if t.get("rejected"):
                emit("tenant_rejected_total", lbl, t["rejected"])
        # elastic membership: handoff/adoption state, stale-routing
        # bounce/retry counters, detector liveness, the gRPC plane and
        # the per-peer breakers
        mem = self.membership
        if mem is not None:
            ms = mem.metrics_snapshot()
            emit("shard_handoff_started_total", {},
                 ms["handoffs_started"])
            emit("shard_handoff_completed_total", {},
                 ms["handoffs_completed"])
            emit("shard_handoff_failed_total", {},
                 ms["handoffs_failed"])
            emit("shard_adoptions_total", {"kind": "planned"},
                 ms["adoptions_planned"])
            emit("shard_adoptions_total", {"kind": "crash"},
                 ms["adoptions_crash"])
            emit("shard_releases_total", {}, ms["releases"])
            emit("membership_draining", {}, ms["draining"])
            emit("membership_incoming_shards", {}, ms["incoming"])
            emit("handback_failures_total", {},
                 ms["handback_failures"])
        emit("stale_routing_bounces_total", {},
             self.stale_routing_bounces)
        emit("stale_routing_retries_total", {},
             self.stale_routing_retries)
        emit("peer_fanout_workers", {}, self.fanout_workers)
        if self.worker_id is not None:
            emit("worker_ordinal", {}, int(self.worker_id))
        bus = self.bus_client
        if bus is not None:
            bs = bus.metrics_snapshot()
            emit("bus_events_published_total", {}, bs["published"])
            emit("bus_events_applied_total", {}, bs["applied"])
            emit("bus_reconnects_total", {}, bs["reconnects"])
            emit("bus_connected", {}, bs["connected"])
        if self.detector is not None:
            emit("detector_thread_wedged", {},
                 1 if self.detector.thread_wedged else 0)
        gs = self.grpc_server
        if gs is not None:
            emit("grpc_rpcs_served_total", {}, gs.rpcs_served)
        if gs is not None or self.grpc_peers or self.grpc_partitions:
            # the repair of ROADMAP C.15: a downgrade is never silent
            fb = self.plane_fallbacks.snapshot()
            peers = sorted(set(self.peers) | set(fb))
            if not peers:
                emit("grpc_plane_fallbacks_total", {}, 0)
            for peer in peers:
                emit("grpc_plane_fallbacks_total", {"peer": peer},
                     fb.get(peer, 0))
        breakers = self.resilience.breakers
        if breakers is not None:
            # per-peer breaker state + retry-policy attempts/retries/
            # exhaustions/rejections from the server-lifetime registry
            for peer, entry in sorted(breakers.metrics_snapshot().items()):
                state = entry.get("state")
                if state is not None:
                    emit("breaker_state",
                         {"peer": peer, "state": state}, 1)
                for k in ("attempts", "retries", "exhaustions",
                          "rejections"):
                    if k in entry:
                        emit(f"peer_call_{k}_total", {"peer": peer},
                             entry[k])
        meter = self.tenant_metering
        if meter is not None:
            # periodic per-tenant cardinality gauges
            # (TenantIngestionMetering.scala publishes these on a timer)
            for prefix, (total, active) in sorted(meter.latest.items()):
                labels = {"_ws_": prefix[0] if len(prefix) > 0 else "",
                          "_ns_": prefix[1] if len(prefix) > 1 else ""}
                emit("tenant_time_series_total", labels, total)
                emit("tenant_time_series_active", labels, active)
            # metering-loop liveness: a stalled/dead snapshot thread
            # shows as a growing last-snapshot age
            emit("tenant_metering_interval_seconds", {},
                 meter.interval_s)
            age = meter.last_snapshot_age_s
            if age is not None:
                emit("tenant_metering_last_snapshot_age_seconds", {},
                     round(age, 3))
            emit("tenant_metering_snapshots_total", {}, meter.snapshots)
        # observability surfaces: tracer + slow-query-log + in-flight
        ts = self.tracer.snapshot()
        emit("traces_started_total", {}, ts["started"])
        emit("traces_stored", {}, ts["stored"])
        emit("slow_queries_total", {}, self.slow_log.snapshot()["recorded"])
        emit("inflight_queries", {}, len(self.inflight))
        sm = self.selfmon
        if sm is not None:
            # loop-liveness gauges (its counters and age ride the global
            # registry, collected below)
            emit("selfmon_alive", {}, 1 if sm.alive else 0)
            emit("selfmon_interval_seconds", {}, sm.interval_s)
        # tail-sampling retention + export health: only once tracing is
        # on (the default exposition stays byte-identical)
        if self.tracer.enabled:
            emit("traces_tail_dropped_total", {}, ts["tail_dropped"])
            for reason, n in sorted(ts["retained"].items()):
                emit("traces_retained_total", {"reason": reason}, n)
        exp = self.tracer.exporter
        if exp is not None:
            es = exp.snapshot()
            emit("trace_export_queue", {}, es["queued"])
            emit("trace_export_enqueued_total", {}, es["enqueued"])
        # sampling-profiler health (the self-time gauges and the tick
        # histogram ride the global registry below)
        prof = self.profiler
        if prof is not None:
            ps = prof.snapshot()
            emit("profiler_running", {}, 1 if ps["running"] else 0)
            emit("profiler_hz", {}, ps["hz"])
            emit("profiler_samples_total", {}, ps["samples"])
            emit("profiler_attributed_samples_total", {},
                 ps["attributed"])
            emit("profiler_distinct_stacks", {}, ps["distinct_stacks"])
            emit("profiler_dropped_stacks_total", {},
                 ps["dropped_stacks"])
        # the global metric registry: counter/gauge families, registered
        # collectors (process stats, the device profiler's executable
        # families) and the stage-latency histograms (query latency, ...)
        obs_metrics.GLOBAL_REGISTRY.collect_into(b, exemplars=exemplars)
        return b
