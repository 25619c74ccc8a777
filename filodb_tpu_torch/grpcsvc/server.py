"""gRPC query service server of the port (the counterpart of
``filodb_tpu.grpcsvc.server``; PromQLGrpcServer.scala:44).

Serves two unary RPCs on `/filodb.QueryService/`:

  * ``FetchRaw`` — the leaf-dispatch data plane: span-bounded raw series
    with node-scoped snapshot keys, protobuf + NibblePack on the wire
    (replaces the base64-JSON POST /api/v1/raw hop).
  * ``Exec`` — whole-query pushdown / federation: evaluate a PromQL
    string locally and return the grid as packed columns
    (exec/PromQlRemoteExec.scala without the JSON).

Implemented over grpcio's generic handlers with identity serializers —
message codecs live in grpcsvc.wire; no protoc codegen needed.

The server lifts grpcio's 4 MiB default message limits to
:data:`~filodb_tpu_torch.grpcsvc.client.MAX_MESSAGE_BYTES` in both
directions, so a full-width ``FetchRaw`` or ``Exec`` reply travels over
gRPC (ROADMAP C.15)."""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Optional

from filodb_tpu_torch.grpcsvc import wire
from filodb_tpu_torch.grpcsvc.client import grpc_options, import_grpc
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import qos

_SERVICE = "filodb.QueryService"


def _req_qos(req) -> Optional[qos.QosContext]:
    """QoS context of a peer hop: tenant/priority decoded off the wire,
    ``forced`` set — the ENTRY node made the admission decision, this
    leg only inherits the charge and the batcher ordering. None when
    the caller sent no tenant (pre-QoS peer or budgets off)."""
    if not req.get("tenant"):
        return None
    return qos.QosContext(tenant=req["tenant"],
                          priority=int(req.get("priority") or 0),
                          forced=True)


class GrpcQueryServer:
    """Binds the service to a FiloHttpServer's query surface (the HTTP
    server owns planners, shard maps, and guardrails; this is a second
    wire onto the same brain)."""

    def __init__(self, http_server, port: int = 0, host: str = "127.0.0.1",
                 max_workers: int = 8):
        grpc = import_grpc()
        self.http = http_server
        # RPCs served, by method; handlers run on ThreadPoolExecutor
        # threads, and an unsynchronized `+= 1` would lose increments
        self.fetch_raw_served = 0
        self.exec_served = 0
        self._rpc_lock = threading.Lock()
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                name = details.method.rsplit("/", 1)[-1]
                if details.method.startswith(f"/{_SERVICE}/"):
                    if name == "FetchRaw":
                        return grpc.unary_unary_rpc_method_handler(
                            outer._fetch_raw,
                            request_deserializer=lambda b: b,
                            response_serializer=lambda b: b)
                    if name == "Exec":
                        return grpc.unary_unary_rpc_method_handler(
                            outer._exec,
                            request_deserializer=lambda b: b,
                            response_serializer=lambda b: b)
                return None

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=grpc_options())
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        # grpc spawns an internal completion-queue polling thread the
        # static analyser cannot see; register its actual entry point so
        # the thread inventory and the sampling profiler attribute it
        try:
            from grpc import _server as _grpc_server
            thread_root("grpc-serve")(_grpc_server._serve)
        except (ImportError, AttributeError):
            pass                # private surface: tolerate its absence

    @property
    def rpcs_served(self) -> int:
        """Every RPC served (the /metrics counter)."""
        with self._rpc_lock:
            return self.fetch_raw_served + self.exec_served

    def start(self) -> "GrpcQueryServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1)

    # -- RPC implementations ---------------------------------------------

    @staticmethod
    def _req_deadline(req, default_timeout_s: float):
        """Server-side deadline propagation: the caller forwarded its
        remaining budget; this node inherits it (clipped to the local
        default so a buggy caller can't grant itself infinity)."""
        from filodb_tpu_torch.parallel.resilience import Deadline
        ms = int(req.get("deadline_ms") or 0)
        if ms <= 0:
            return None
        return Deadline.after(min(ms / 1000.0, default_timeout_s))

    def _req_trace(self, req):
        """A local Trace for a propagated context (trace propagation on
        the binary plane): spans recorded here ship back in the
        response and the CALLER's recorder stitches them — nothing is
        stored on this node. None (no tracing at all) when the caller
        didn't forward a context."""
        ctx = obs_trace.parse_context(req.get("trace"))
        if ctx is None:
            return None
        tracer = getattr(self.http, "tracer", None)
        if tracer is not None:
            return tracer.start(ctx)
        return obs_trace.Trace(ctx[0], root_parent=ctx[1])

    def _fetch_raw(self, request: bytes, context) -> bytes:
        from filodb_tpu_torch.query.model import QueryError, QueryStats
        with self._rpc_lock:
            self.fetch_raw_served += 1
        tr = None
        try:
            req = wire.decode_raw_request(request)
            tr = self._req_trace(req)
            qctx = _req_qos(req)
            adm = getattr(self.http, "admission", None)
            if qctx is not None and adm is not None \
                    and adm.budgets.enabled:
                # budget inheritance: the leg's cost lands on the same
                # tenant bucket the entry node charged (forced — a leg
                # must never shed mid-query)
                shards = self.http.shards_by_dataset.get(
                    req["dataset"], ())
                adm.budgets.charge_forced(
                    qctx.tenant, qos.estimate_leaf_cost(
                        req["filters"], shards, req["start_ms"],
                        req["end_ms"]))
            with qos.activate(qctx), obs_trace.activate(tr), \
                    obs_trace.span("peer-fetch-raw",
                                   node=getattr(self.http, "node_id", "")
                                   or "", dataset=req["dataset"]):
                series = self.http.leaf_select(
                    req["dataset"], req["filters"], req["start_ms"],
                    req["end_ms"], req["column"], req["shards"],
                    span_snap=req["span_snap"], stats=QueryStats(),
                    deadline=self._req_deadline(
                        req, getattr(self.http, "query_timeout_s",
                                     30.0)))
            if series is None:
                return wire.encode_raw_response(
                    [], error=f"dataset {req['dataset']} not set up",
                    trace_spans=obs_trace.spans_wire(tr))
            return wire.encode_raw_response(
                series, trace_spans=obs_trace.spans_wire(tr))
        except QueryError as e:
            return wire.encode_raw_response(
                [], error=str(e), trace_spans=obs_trace.spans_wire(tr))
        except Exception as e:           # wire errors back, never crash
            return wire.encode_raw_response(
                [], error=f"internal: {type(e).__name__}: {e}",
                trace_spans=obs_trace.spans_wire(tr))

    def _exec(self, request: bytes, context) -> bytes:
        from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                    parse_query,
                                                    parse_query_range)
        from filodb_tpu_torch.query.model import (GridResult, QueryError,
                                                  ScalarResult)
        with self._rpc_lock:
            self.exec_served += 1
        tr = None
        try:
            req = wire.decode_exec_request(request)
            tr = self._req_trace(req)
            if req["local_only"] and req.get("expect_shards"):
                # stale-routing guard (ExecRequest field 12): bounce
                # instead of silently evaluating over a subset when a
                # planned handoff moved one of the expected shards away
                have = {getattr(s, "shard_num", i) for i, s in
                        enumerate(self.http.shards_by_dataset.get(
                            req["dataset"], ()))}
                missing = [n for n in req["expect_shards"]
                           if n not in have]
                if missing:
                    from filodb_tpu_torch.query.model import StaleRoutingError
                    mapper = self.http.shard_mapper
                    self.http.stale_routing_bounces += 1
                    err = StaleRoutingError(
                        owners={n: mapper.node_of(n) for n in missing}
                        if mapper is not None else {},
                        epoch=getattr(mapper, "topology_epoch", 0)
                        if mapper is not None else 0,
                        node=getattr(self.http, "node_id", "") or "",
                        detail=f"shards {sorted(missing)} are not "
                               f"served here")
                    return wire.encode_exec_response(
                        None, error=str(err),
                        trace_spans=obs_trace.spans_wire(tr))
            engine = self.http.make_planner(
                req["dataset"], local_dispatch=req["local_only"],
                deadline=self._req_deadline(
                    req, getattr(self.http, "query_timeout_s", 30.0)),
                no_result_cache=bool(req.get("no_cache")))
            if engine is None:
                return wire.encode_exec_response(
                    None, error=f"dataset {req['dataset']} not set up",
                    trace_spans=obs_trace.spans_wire(tr))
            qctx = _req_qos(req)
            with qos.activate(qctx), obs_trace.activate(tr), \
                    obs_trace.span("peer-exec",
                                   node=getattr(self.http, "node_id", "")
                                   or "", dataset=req["dataset"]):
                if req["plan_wire"]:
                    # structural plan tree: no PromQL printer/parser in
                    # the loop (exec_plan.proto capability)
                    from filodb_tpu_torch.query.planwire import plan_from_wire
                    plan = plan_from_wire(req["plan_wire"])
                elif req["step_ms"] > 0:
                    plan = parse_query_range(
                        req["query"],
                        TimeStepParams(req["start_ms"] // 1000,
                                       req["step_ms"] // 1000,
                                       req["end_ms"] // 1000))
                else:
                    plan = parse_query(req["query"],
                                       req["start_ms"] // 1000)
                adm = getattr(self.http, "admission", None)
                if qctx is not None and adm is not None \
                        and adm.budgets.enabled:
                    # budget inheritance on the exec plane: forced —
                    # the entry node already made the shed decision
                    adm.budgets.charge_forced(
                        qctx.tenant,
                        engine.estimate_cost(plan).total)
                rc = getattr(self.http, "result_cache", None)
                if rc is not None and not req["plan_wire"] \
                        and req["step_ms"] > 0:
                    # pushdown/federation range queries share the
                    # node's results cache (the &cache=false escape
                    # hatch rides ExecRequest field 11 as no_cache)
                    res, _ses = rc.execute(
                        engine, req["dataset"], req["query"], plan,
                        req["start_ms"], req["step_ms"], req["end_ms"],
                        bypass=bool(req.get("no_cache")))
                else:
                    res = engine.execute(plan)
            if isinstance(res, ScalarResult):
                res = GridResult(res.steps, [{}], res.values[None, :])
            return wire.encode_exec_response(
                res, stats=engine.stats,
                trace_spans=obs_trace.spans_wire(tr))
        except QueryError as e:
            return wire.encode_exec_response(
                None, error=str(e),
                trace_spans=obs_trace.spans_wire(tr))
        except Exception as e:
            return wire.encode_exec_response(
                None, error=f"internal: {type(e).__name__}: {e}",
                trace_spans=obs_trace.spans_wire(tr))
