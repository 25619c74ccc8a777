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
  GET      /api/v1/cardinality/{dataset}?prefix&depth
  GET      /metrics
  GET      /debug/queries | /debug/slow_queries | /debug/traces |
           /debug/events

Query endpoints pass the admission gate (bounded in-flight evaluations,
429 + Retry-After on saturation), the tenant QoS ladder, the plan cache
and the results cache before the planner and the engine.

The reference checks its per-query deadline (``&timeout=``,
``query-timeout-s``) and honours ``&allow_partial=`` only on its remote and
mesh paths, none of which is ported: this edge takes neither yet.

A route whose feature is off by config answers as the reference does with
that feature off (rules, alerts, influx ingest without a gateway, profile,
admin). A route the reference serves whatever its config, but whose module
the port does not have yet, answers 501 with the ROADMAP item that ports
it: ``&explain=analyze``, the peer leaf-dispatch plane (``/api/v1/raw``)
and the thread inventory (``/debug/threads``).

stdlib http.server (the JVM reference uses Akka-HTTP; the edge is not the
hot path — all bulk compute is device-side behind QueryEngine)."""

from __future__ import annotations

import functools
import json
import re
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.http import prom_json
from filodb_tpu_torch.ingest import health as ingest_health
from filodb_tpu_torch.obs import SELFMON_DATASET
from filodb_tpu_torch.obs import events as obs_events
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.obs.slowlog import InflightRegistry, SlowQueryLog
from filodb_tpu_torch.obs.trace import Tracer
from filodb_tpu_torch.promql.parser import (TimeStepParams, parse_query,
                                            parse_query_range,
                                            selector_to_filters)
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.planner import QueryPlanner
from filodb_tpu_torch.query.model import (GridResult, QueryError,
                                          QueryLimitError, QueryLimits,
                                          ScalarResult)

_ROUTE = re.compile(r"^/promql/(?P<ds>[^/]+)/api/v1/(?P<rest>.+)$")

# reserved internal datasets: strictly node-local planners, own cardinality
# accounting (__selfmon__ holds self-ingested telemetry; __rules__ holds
# recording-rule outputs)
INTERNAL_DATASETS = (SELFMON_DATASET, qos.RULES_TENANT)

_QLAT_HELP = ("End-to-end query latency in seconds at the HTTP edge "
              "(parse + plan + execute + encode)")

# routes the reference serves whatever its config, whose modules the port
# does not have yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "explain=analyze": "A.9 device observability (obs/devprof.py)",
    "raw": "A.1.4 multi-node and membership (leaf dispatch)",
    "threads": "A.12 certification rail (thread inventory)",
}


def _not_ported(what: str):
    return 501, prom_json.error(
        f"{what} is not ported yet (ROADMAP {_NOT_PORTED[what]})",
        "not_implemented")


# promlint findings per query text: queries repeat (dashboards), the
# analysis is pure, and the hot path must not re-walk the AST per refresh
@functools.lru_cache(maxsize=512)
def _lint_memo(query: str) -> Tuple:
    from filodb_tpu_torch.promql import semant
    return tuple(semant.lint_query(query, semant.MetricSchemas({})))


class _Handled(Exception):
    """Control-flow: response (code, payload) already decided."""


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
                 spread: int = 1,   # MUST match ingest spread (default-spread)
                 host: str = "127.0.0.1", port: int = 0,
                 query_limits: Optional[QueryLimits] = None,
                 spread_provider: Optional[object] = None,
                 node_id: Optional[str] = None,
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
                 slow_query_capacity: int = 128):
        self.shards_by_dataset = shards_by_dataset
        self.backend = backend
        self.shard_mapper = shard_mapper
        self.spread = spread
        self.query_limits = query_limits
        self.spread_provider = spread_provider
        self.node_id = node_id
        # the GatewayServer behind /api/v1/ingest/influx (the remote
        # ingest edge with an ack channel); None = no gateway here
        self.gateway = None
        # core/metering.TenantMetering: the /metrics tenant families and
        # the QoS cost of the planner; None = metering off
        self.tenant_metering = None
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

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="accept-edge")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request handling -------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        retry_after_s: Optional[float] = None
        body_raw = b""
        try:
            parsed = urllib.parse.urlparse(req.path)
            qs = urllib.parse.parse_qs(parsed.query)
            if req.command == "POST":
                ln = int(req.headers.get("Content-Length") or 0)
                if ln > (64 << 20):     # request-size cap (DoS guard)
                    code, payload = 413, prom_json.error(
                        "request body too large")
                    raise _Handled()
                body_raw = req.rfile.read(ln) if ln else b""
                ctype = req.headers.get("Content-Type", "")
                if "application/x-www-form-urlencoded" in ctype:
                    for k, v in urllib.parse.parse_qs(
                            body_raw.decode()).items():
                        qs.setdefault(k, []).extend(v)
            code, payload = self._route(
                parsed.path, qs, body_raw,
                tenant_hdr=req.headers.get(qos.TENANT_HEADER),
                priority_hdr=req.headers.get(qos.PRIORITY_HEADER))
        except _Handled:
            pass
        except qos.AdmissionRejected as e:
            # admission said no and no degraded answer exists: 429 +
            # Retry-After. Distinct from the 503 deadline path below —
            # a rejected query was never executed, so the client can
            # back off and resubmit as-is.
            code, payload = 429, prom_json.error(str(e), "throttled")
            retry_after_s = e.retry_after_s
        except ingest_health.IngestReadOnly as e:
            # the ingest edge while write-path out-of-space degradation
            # is active: recoverable — resubmit after space is freed
            code, payload = 503, prom_json.error(str(e), "read_only")
            retry_after_s = e.retry_after_s
        except QueryLimitError as e:
            code, payload = 422, prom_json.error(str(e), "query_limit")
        except QueryError as e:
            code, payload = 400, prom_json.error(str(e))
        except Exception as e:   # noqa: BLE001 — edge must not crash
            code, payload = 500, prom_json.error(str(e), "internal")
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
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        for k, v in extra_headers.items():
            req.send_header(k, v)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _route(self, path: str, qs: Dict, body_raw: bytes = b"",
               tenant_hdr: Optional[str] = None,
               priority_hdr: Optional[str] = None):
        if path in ("/__health", "/__liveness", "/__readiness"):
            # locally-served shards with their FSM status, per-shard
            # ingest watermarks + backfill epochs, and the integrity
            # flags (HealthRoute + the reference's gossip body)
            shards_adv: Dict[str, str] = {}
            watermarks: Dict[str, int] = {}
            epochs: Dict[str, int] = {}
            quarantined: Dict[str, int] = {}
            integrity_ro: List[str] = []
            for lst in self.shards_by_dataset.values():
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
            body = {"status": "healthy", "shards": shards_adv,
                    "down_peers": [],
                    "watermarks": watermarks,
                    "backfill_epochs": epochs,
                    "ingest_read_only":
                        ingest_health.GLOBAL.read_only(),
                    "integrity": {"quarantined": quarantined,
                                  "read_only_shards": integrity_ro}}
            if self.shard_mapper is not None:
                body["topo_epoch"] = self.shard_mapper.topology_epoch
            body["grpc_peers"] = {}
            return 200, body
        if path == "/metrics":
            # ?exemplars=1: OpenMetrics exemplar suffixes on histogram
            # buckets; the plain exposition stays byte-identical without
            want_ex = (self._param(qs, "exemplars", "")
                       or "").lower() in ("1", "true", "yes")
            return 200, self._metrics_text(exemplars=want_ex)
        if path.startswith("/admin/"):
            # the planned-membership control plane is off on this node
            return 400, prom_json.error(
                "elastic membership is not enabled on this node")
        if path == "/debug/traces":
            return 200, self._debug_traces(qs)
        if path == "/debug/profile":
            return 404, {"status": "error", "errorType": "unavailable",
                         "error": "profiler not configured "
                                  "(--profiler-enabled)"}
        if path == "/debug/queries":
            return 200, {"status": "success",
                         "data": self.inflight.snapshot()}
        if path == "/debug/threads":
            return _not_ported("threads")
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
            return 200, {"status": "success",
                         "data": {"groups": [], "evaluating": False}}
        if path == "/api/v1/alerts":
            return 200, {"status": "success", "data": {"alerts": []}}
        m = re.match(r"^/api/v1/cluster/(?P<ds>[^/]+)/status$", path)
        if m:
            return 200, self._cluster_status(m.group("ds"))
        if re.match(r"^/api/v1/raw/(?P<ds>[^/]+)$", path):
            return _not_ported("raw")
        m = re.match(r"^/api/v1/cardinality(-local)?/(?P<ds>[^/]+)$", path)
        if m:
            return self._cardinality(m.group("ds"), qs)
        m = _ROUTE.match(path)
        if not m:
            return 404, prom_json.error(f"no route for {path}", "not_found")
        ds, rest = m.group("ds"), m.group("rest")
        if rest in ("query_range", "query"):
            if self._param(qs, "explain") == "analyze":
                return _not_ported("explain=analyze")
            engine = self.make_planner(ds)
            if engine is None:
                raise QueryError(f"dataset {ds} not set up")
            if rest == "query_range":
                fn = lambda: self._query_range(engine, qs, ds)  # noqa: E731
            else:
                fn = lambda: self._query_instant(engine, qs, ds)  # noqa: E731
            # tenant QoS: identity from &tenant= / X-Filo-Tenant (by
            # convention the workspace), priority class from &priority= /
            # X-Filo-Priority. The reserved internal tenants charge FORCED
            # and run at the background class unless a priority was
            # explicit.
            tenant = (self._param(qs, "tenant") or tenant_hdr
                      or qos.DEFAULT_TENANT)
            raw_priority = self._param(qs, "priority") or priority_hdr
            priority = qos.parse_priority(raw_priority)
            internal_tenant = tenant in qos.INTERNAL_TENANTS
            if internal_tenant and not raw_priority:
                priority = qos.PRIORITY_BACKGROUND
            qctx = qos.QosContext(tenant=tenant, priority=priority,
                                  forced=internal_tenant)
            adm = self.admission
            try:
                if not adm.gated:
                    with qos.activate(qctx):
                        return fn()
                with adm.slot(tenant=qctx.tenant):
                    with qos.activate(qctx):
                        return fn()
            except qos.AdmissionRejected as e:
                # host saturation leaves one free rung: a stale cached
                # extent costs neither a slot nor compute. Over-budget
                # rejections already walked the full ladder — re-raise.
                if e.reason != "saturated" or rest != "query_range":
                    raise
                out = self._shed_stale_saturated(ds, qs, qctx)
                if out is None:
                    raise
                return out
        if rest == "read":
            return self._remote_read(ds, body_raw)
        engine = self.make_planner(ds)
        if engine is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        if rest == "labels":
            return self._labels(engine, qs)
        lm = re.match(r"^label/(?P<name>[^/]+)/values$", rest)
        if lm:
            return self._label_values(engine, lm.group("name"), qs)
        if rest == "series":
            return self._series(engine, qs)
        return 404, prom_json.error(f"no route for {path}", "not_found")

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
           normal materialize path;
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
            available."""
            cost_x = engine.estimate_cost(plan_x).total
            if not budgets.try_charge(tenant, cost_x):
                return None
            obs_trace.event("qos-shed", rung=rung, tenant=tenant)
            try:
                res = engine.materialize(plan_x).execute()
            except qos.AdmissionRejected:
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

    def _shed_stale_saturated(self, ds: str, qs: Dict, qctx
                              ) -> Optional[Tuple[int, object]]:
        """Host-saturation fallback: the bounded admission wait timed
        out, but a stale cached extent needs neither a slot nor
        compute — parse (plan cache) and look it up. None when there
        is no usable extent or the client sent &cache=false (the caller
        answers 429)."""
        no_cache = (self._param(qs, "cache", "")
                    or "").lower() in ("false", "0", "no")
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
        engine = self.make_planner(ds)
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
        stats_json = self._query_stats(engine, res)
        if isinstance(res, GridResult) and not res.is_hist():
            st = engine.stats
            warnings = list(getattr(st, "warnings", ()) or ())
            warnings.extend(w for w in res.warnings
                            if w not in warnings)
            partial = bool(getattr(st, "partial", False) or res.partial)
            return prom_json.matrix_bytes(res, stats_json,
                                          warnings=warnings,
                                          partial=partial)
        out = prom_json.matrix(res)
        out["stats"] = stats_json
        prom_json.attach_degraded(out, res, engine.stats)
        return out

    def make_planner(self, ds: str):
        """Planner over this node's view of a dataset. A reserved
        internal dataset is planned over its local shards only, with no
        shard mapper."""
        shards = self.shards_by_dataset.get(ds)
        if shards is None:
            return None
        internal = ds in INTERNAL_DATASETS
        planner = QueryPlanner(
            shards, backend=self.backend,
            shard_mapper=None if internal else self.shard_mapper,
            spread=self.spread,
            spread_provider=None if internal else self.spread_provider,
            limits=self.query_limits)
        # QoS cost estimation reads the metering snapshot
        planner.metering = self.tenant_metering
        return planner

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

    def _promql_lint(self, engine, qs, query: str):
        """promlint on a user query: findings ride the response
        ``warnings`` array; ``&lint=strict`` turns error-severity
        findings into a 400 with structured diagnostics;
        ``&lint=off`` skips. Returns None to proceed, or a (code,
        payload) rejection."""
        mode = (self._param(qs, "lint", "") or "").lower()
        if mode == "off":
            return None
        diags = _lint_memo(query)
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

    def _query_range(self, engine, qs, ds: str):
        import time as _time
        query = self._param(qs, "query")
        if not query:
            raise QueryError("missing query parameter")
        start = int(float(self._param(qs, "start", "0")))
        end = int(float(self._param(qs, "end", "0")))
        step = int(float(self._param(qs, "step", "10")))
        if end < start:
            raise QueryError("end < start")
        # tracing: fresh requests sample per tracer policy;
        # &explain=trace forces a trace for this one request and inlines
        # it in the response
        explain_trace = self._param(qs, "explain") == "trace"
        tr = self.tracer.start(None, force=explain_trace)
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
                        stages, force_dict=explain_trace)
            if explain_trace and isinstance(payload, dict):
                payload["trace"] = tr.to_json()
            return code, payload
        finally:
            # tail retention runs HERE so every exit path (success,
            # QueryError, shed, crash) decides the trace's fate exactly
            # once, with the outcome in hand
            total_s = _time.perf_counter() - t0
            self.inflight.unregister(entry)
            tr = self._finish_request_trace(
                tr, code, total_s, stages, force=explain_trace)
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
        encode off the pre-encoded fast path so the trace can attach."""
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
        if isinstance(res, GridResult) and not res.is_hist() \
                and not force_dict:
            # serving fast path: bulk matrix rows encode straight to
            # JSON bytes (memoized ts/value fragments), skipping the
            # dict tree + json.dumps walk
            st = engine.stats
            warnings = list(getattr(st, "warnings", ()) or ())
            warnings.extend(res.warnings)
            partial = bool(getattr(st, "partial", False) or res.partial)
            out = prom_json.matrix_bytes(
                res, stats_json, warnings=warnings, partial=partial,
                rows_memo=ses.encode_memo())
            stages["encodeMs"] = round(
                (_time.perf_counter() - t3) * 1000, 3)
            return 200, out
        with obs_trace.span("encode"):
            out = prom_json.matrix(res)
            out["stats"] = stats_json
            prom_json.attach_degraded(out, res, engine.stats)
        stages["encodeMs"] = round((_time.perf_counter() - t3) * 1000, 3)
        return 200, out

    def _finish_request_trace(self, tr, code: int, total_s: float,
                              stages: Dict, force: bool = False):
        """The tail-retention decision for one finished request (called
        from the query paths' ``finally``): errors (exception in
        flight or a 4xx/5xx answer), QoS-shed/degraded rungs, and
        latency at/above the slow-query threshold always retain the
        pending trace; the rest keep the start-time sampling coin.
        Returns the trace iff it was retained (i.e. its id resolves in
        ``/debug/traces``) — callers link slowlog records and latency
        exemplars only to that."""
        if tr is None:
            return None
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
            "shards": sorted(int(getattr(s, "shard_num", -1))
                             for s in getattr(engine, "shards", ())),
            "seriesScanned": getattr(st, "series_scanned", 0),
            "samplesScanned": getattr(st, "samples_scanned", 0),
            "partial": bool(getattr(st, "partial", False)),
            "warnings": list(getattr(st, "warnings", ()) or ()),
        }
        if tr is not None:
            rec["trace_id"] = tr.trace_id
        self.slow_log.maybe_record(total_s * 1000, rec)

    def _query_instant(self, engine, qs, ds: str):
        import time as _time
        query = self._param(qs, "query")
        if not query:
            raise QueryError("missing query parameter")
        time_s = int(float(self._param(qs, "time", "0")))
        explain_trace = self._param(qs, "explain") == "trace"
        tr = self.tracer.start(None, force=explain_trace)
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
            if explain_trace and isinstance(payload, dict):
                payload["trace"] = tr.to_json()
            return code, payload
        finally:
            total_s = _time.perf_counter() - t0
            self.inflight.unregister(entry)
            tr = self._finish_request_trace(
                tr, code, total_s, stages, force=explain_trace)
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

    def _labels(self, engine, qs):
        # Prometheus semantics: result is the UNION over all match[]
        # selectors (none -> all series).
        start, end = self._time_range(qs)
        out: set = set()
        for sel in qs.get("match[]", []) or [None]:
            filters = selector_to_filters(sel) if sel else ()
            out.update(engine.execute(lp.LabelNames(list(filters),
                                                    start, end)))
        return 200, prom_json.success(sorted(out))

    def _label_values(self, engine, name, qs):
        start, end = self._time_range(qs)
        out: set = set()
        for sel in qs.get("match[]", []) or [None]:
            filters = selector_to_filters(sel) if sel else ()
            out.update(engine.execute(lp.LabelValues(name, list(filters),
                                                     start, end)))
        return 200, prom_json.success(sorted(out))

    def _series(self, engine, qs):
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

    def _cardinality(self, ds: str, qs: Dict):
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
        return 200, prom_json.success([r.to_json() for r in recs])

    # -- Prometheus remote-read -------------------------------------------
    def _remote_read(self, ds: str, body_raw: bytes):
        """POST /promql/{ds}/api/v1/read: snappy(ReadRequest protobuf) ->
        snappy(ReadResponse) (remote-storage.proto;
        PrometheusApiRoute.scala:129). The reference resolves shards
        through its cluster planner; this node's planner covers its own
        shards, which on one node are all of them."""
        from filodb_tpu_torch.core.index import ColumnFilter
        from filodb_tpu_torch.http import remote_read as rr
        from filodb_tpu_torch.query.engine import select_raw_series
        from filodb_tpu_torch.query.model import QueryStats
        planner = self.make_planner(ds)
        if planner is None:
            return 400, prom_json.error(f"dataset {ds} not set up")
        if not body_raw:
            return 400, prom_json.error("missing remote-read body")
        try:
            queries = rr.decode_read_request(
                rr.snappy_decompress(body_raw))
        except (ValueError, IndexError) as e:
            raise QueryError(f"bad remote-read request: {e}")
        results = []
        for q in queries:
            # Prometheus clients send __name__; the index stores the
            # metric under the schema's metric column (_metric_), the
            # same mapping the PromQL parser applies
            filters = [ColumnFilter(
                "_metric_" if n == "__name__" else n, op, v)
                for n, op, v in q["matchers"]]
            plan = lp.RawSeriesPlan(tuple(filters), q["start_ms"],
                                    q["end_ms"])
            series = select_raw_series(
                planner._resolve_shards(plan), filters,
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

    # HELP text per family (fallback: a generic string). Kept verbose —
    # operators read this off the exposition, not the source.
    _METRIC_HELP = {
        "filodb_shard_status": "Shard FSM status (1 per shard; labels "
                               "carry status/node)",
        "filodb_cardinality_total_series": "Total series tracked by the "
                                           "shard's cardinality tracker",
        "filodb_cardinality_active_series": "Actively-ingesting series",
        "filodb_tile_cache_entries": "Device tile-cache entries",
        "filodb_tile_builds_total": "Device tile (re)builds",
        "filodb_tile_cache_hits_total": "Device tile-cache hits",
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
        # the global metric registry: counter/gauge families and the
        # stage-latency histograms (query latency, ...)
        obs_metrics.GLOBAL_REGISTRY.collect_into(b, exemplars=exemplars)
        return b
