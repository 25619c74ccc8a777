"""gRPC query service clients: drop-in peers for the planner.

``GrpcShardGroup`` replaces ``parallel.cluster.RemoteShardGroup`` (leaf
dispatch) and ``GrpcRemoteExec`` replaces ``PromQlRemoteExec``
(whole-query pushdown / federation) when a peer advertises a gRPC
address. Channels are cached per address — gRPC keeps one persistent
HTTP/2 connection per peer and multiplexes RPCs over it
(PromQLGrpcServer.scala client side; RemoteActorPlanDispatcher).

Degraded-mode behavior (parallel/resilience.py): transport failures map
to TransportError, retry per policy inside the query's deadline budget,
and count against the peer address's circuit breaker. When the binary
data plane is exhausted (retries spent or breaker open) and the caller
provided an HTTP fallback URL, the call falls back to the JSON control
plane — a restarted peer whose gRPC port moved keeps serving through
HTTP while the failure detector re-learns the new address.

Two repairs against the reference (``filodb_tpu.grpcsvc.client``), both
in ROADMAP C.15: channels lift grpcio's 4 MiB default message limits to
:data:`MAX_MESSAGE_BYTES` (a full-width ``FetchRaw`` or ``Exec`` reply is
tens of MB, and the default turned every such call into an HTTP JSON
fallback), and every fallback is counted in the caller's
:class:`PlaneFallbacks` (``filodb_grpc_plane_fallbacks_total`` on
``/metrics``) as well as in the trace."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.grpcsvc import wire
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.parallel.resilience import (BreakerRegistry,
                                                  Deadline, RetryPolicy,
                                                  TransportError,
                                                  resilient_call)
from filodb_tpu_torch.query.model import (QueryError, RawSeries,
                                          StaleRoutingError)
from filodb_tpu_torch.testing import chaos


def _raise_peer_error(node_id: str, error: str) -> None:
    """Map a peer's error string back to the right exception: a
    stale-routing sentinel (the peer no longer serves the shards we
    routed at it) round-trips losslessly through the wire's error
    field; anything else is a plain peer QueryError."""
    sr = StaleRoutingError.parse(error)
    if sr is not None:
        raise sr
    raise QueryError(f"remote node {node_id}: {error}")

_SERVICE = "filodb.QueryService"
# the channel cache is shared by every query thread dialing peers
_channels: Dict[str, object] = {}
_channels_lock = threading.Lock()

# send and receive limit of one gRPC message, on channels and on the
# server. grpcio's default receive limit is 4 MiB; a leaf fetch at full
# width is tens of MB (4,096 series x 2,880 samples NibblePacked) and a
# pushed-down join's reply ~15 MB. 1 GiB stays below protobuf's 2 GiB
# ceiling; the per-query sample and series limits bound a reply well
# under it at their defaults.
MAX_MESSAGE_BYTES = 1 << 30


def grpc_options():
    """Channel and server options: the message-size limits above."""
    return [("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES)]


def import_grpc():
    """The grpc module, or an ImportError naming the grpcio package: a
    gRPC plane that is asked for is never dropped quietly."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC plane (grpc-port, grpc-peers) needs the grpcio "
            "package, which is not installed") from e
    return grpc


class PlaneFallbacks:
    """Count of leaf fetches and pushdowns that fell back from the gRPC
    plane to the HTTP JSON plane, by peer node (one per entry node; the
    HTTP server publishes it as ``filodb_grpc_plane_fallbacks_total``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_peer: Dict[str, int] = {}

    def note(self, node_id: str) -> None:
        with self._lock:
            self._by_peer[node_id] = self._by_peer.get(node_id, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_peer)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._by_peer.values())


def _note_fallback(fallbacks: Optional[PlaneFallbacks],
                   node_id: str) -> None:
    obs_trace.event("plane-fallback", node=node_id, to="http")
    if fallbacks is not None:
        fallbacks.note(node_id)


def _channel(addr: str):
    grpc = import_grpc()
    with _channels_lock:
        ch = _channels.get(addr)
        if ch is None:
            ch = grpc.insecure_channel(addr, options=grpc_options())
            _channels[addr] = ch
        return ch


def drop_channel(addr: str) -> None:
    """Evict + close the cached channel for a peer that died or moved
    to a new ephemeral port (the failure detector calls this when the
    peer sink is invalidated)."""
    with _channels_lock:
        ch = _channels.pop(addr, None)
    if ch is not None:
        try:
            ch.close()
        except Exception:
            pass


def _call(addr: str, method: str, payload: bytes, timeout_s: float,
          node_id: str) -> bytes:
    grpc = import_grpc()
    try:
        chaos.fire("grpc.call", node=node_id, addr=addr, method=method)
        stub = _channel(addr).unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        return stub(payload, timeout=timeout_s)
    except grpc.RpcError as e:
        raise TransportError(f"remote node {node_id} grpc unreachable: "
                             f"{e.code().name}")
    except OSError as e:                     # injected/chaos connection
        raise TransportError(f"remote node {node_id} grpc unreachable: "
                             f"{e}")


class GrpcShardGroup:
    """Peer leaf dispatch over gRPC (see RemoteShardGroup for the plan
    contract: stands in a planner shard list for one peer's shards).

    ``http_fallback`` (the peer's HTTP base URL) downgrades the fetch to
    the JSON control plane when the gRPC plane is exhausted."""

    def __init__(self, node_id: str, addr: str, dataset: str,
                 shard_nums: Optional[Sequence[int]],
                 timeout_s: float = 60.0,
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 deadline: Optional[Deadline] = None,
                 allow_partial: bool = False,
                 http_fallback: Optional[str] = None,
                 fallbacks: Optional[PlaneFallbacks] = None):
        self.node_id = node_id
        self.addr = addr
        self.dataset = dataset
        self.shard_nums = list(shard_nums) if shard_nums is not None \
            else None
        self.timeout_s = timeout_s
        self.retry = retry
        self.breakers = breakers
        self.deadline = deadline
        self.allow_partial = allow_partial
        self.http_fallback = http_fallback
        self.fallbacks = fallbacks
        self.shard_num = tuple(self.shard_nums or ())

    def describe(self) -> str:
        sh = ("all" if self.shard_nums is None
              else ",".join(map(str, self.shard_nums)))
        return f"shards [{sh}] on {self.node_id}"

    def _http_group(self):
        from filodb_tpu_torch.parallel.cluster import RemoteShardGroup
        return RemoteShardGroup(
            self.node_id, self.http_fallback, self.dataset,
            self.shard_nums, timeout_s=self.timeout_s, retry=self.retry,
            breakers=self.breakers, deadline=self.deadline,
            allow_partial=self.allow_partial)

    def _deadline_ms(self) -> int:
        """Caller's remaining budget, forwarded so the peer inherits it
        (server-side deadline propagation); 0 = no deadline."""
        if self.deadline is None:
            return 0
        return max(int(self.deadline.remaining() * 1000), 1)

    def fetch_raw(self, filters, start_ms: int, end_ms: int,
                  column: Optional[str],
                  full: bool = True) -> List[RawSeries]:
        with obs_trace.span("remote-peer", node=self.node_id,
                            plane="grpc", rpc="FetchRaw",
                            addr=self.addr):
            return self._fetch_raw(filters, start_ms, end_ms, column,
                                   full)

    def _fetch_raw(self, filters, start_ms: int, end_ms: int,
                   column: Optional[str],
                   full: bool = True) -> List[RawSeries]:
        def dial(timeout_s: float) -> bytes:
            # payload re-encoded per attempt: a retry must forward the
            # REMAINING budget, not the original one (the trace context
            # is re-read too: the parent is the live attempt span).
            # Tenant/priority ride along so the peer force-charges the
            # same budget and orders its batcher by the same class.
            qctx = qos.current()
            payload = wire.encode_raw_request(
                self.dataset, filters, start_ms, end_ms, column,
                self.shard_nums, span_snap=bool(full),
                deadline_ms=self._deadline_ms(),
                trace_ctx=obs_trace.inject_header() or "",
                tenant=qctx.tenant if qctx is not None else "",
                priority=qctx.priority if qctx is not None else 0)
            return _call(self.addr, "FetchRaw", payload, timeout_s,
                         self.node_id)

        try:
            buf = resilient_call(
                dial, key=self.addr, node_id=self.node_id,
                timeout_s=self.timeout_s, retry=self.retry,
                breakers=self.breakers, deadline=self.deadline)
        except TransportError:
            if self.http_fallback is None:
                raise
            # binary plane down: downgrade to the JSON control plane
            _note_fallback(self.fallbacks, self.node_id)
            return self._http_group().fetch_raw(
                filters, start_ms, end_ms, column, full=full)
        series, error, spans = wire.decode_raw_response(buf)
        obs_trace.absorb_wire(spans)      # stitch the peer's subspans
        if error:
            _raise_peer_error(self.node_id, error)
        return series

    def lookup_partitions(self, filters, start_ts, end_ts):
        return []


class GrpcRemoteExec:
    """Whole-query pushdown over gRPC: the peer evaluates the PromQL and
    ships the grid as packed columns (PromQlRemoteExec semantics without
    the JSON hop). Falls back to PromQlRemoteExec over ``http_fallback``
    when the binary plane is exhausted."""

    def __init__(self, query: str, start_ms: int, step_ms: int,
                 end_ms: int, node_id: str, addr: str, dataset: str,
                 timeout_s: float = 60.0, stats=None,
                 local_only: bool = True, plan_wire: bytes = b"",
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 deadline: Optional[Deadline] = None,
                 http_fallback: Optional[str] = None,
                 no_cache: bool = False,
                 expect_shards: Optional[Sequence[int]] = None,
                 fallbacks: Optional[PlaneFallbacks] = None):
        self.fallbacks = fallbacks
        # structural plan tree (query.planwire); when present the peer
        # executes it directly and `query` is only a debug label
        self.plan_wire = plan_wire
        # stale-routing guard: the shards the entry node believes this
        # peer owns; the peer bounces instead of silently evaluating a
        # subset when a handoff moved one away (ExecRequest field 12)
        self.expect_shards = list(expect_shards) \
            if expect_shards is not None else None
        self.query = query
        self.start_ms = start_ms
        self.step_ms = step_ms
        self.end_ms = end_ms
        self.node_id = node_id
        self.addr = addr
        self.dataset = dataset
        self.timeout_s = timeout_s
        self.stats = stats
        self.local_only = local_only
        self.retry = retry
        self.breakers = breakers
        self.deadline = deadline
        self.http_fallback = http_fallback
        # &cache=false propagation across the binary plane (ExecRequest
        # field 11): the peer skips its results cache for this query
        self.no_cache = no_cache

    def _fallback_exec(self):
        from filodb_tpu_torch.parallel.cluster import PromQlRemoteExec
        return PromQlRemoteExec(
            self.query, self.start_ms, self.step_ms, self.end_ms,
            self.node_id, self.http_fallback, self.dataset,
            timeout_s=self.timeout_s, stats=self.stats,
            local_only=self.local_only, retry=self.retry,
            breakers=self.breakers, deadline=self.deadline,
            no_cache=self.no_cache, expect_shards=self.expect_shards)

    def _deadline_ms(self) -> int:
        if self.deadline is None:
            return 0
        return max(int(self.deadline.remaining() * 1000), 1)

    def execute(self):
        with obs_trace.span("remote-peer", node=self.node_id,
                            plane="grpc", rpc="Exec", addr=self.addr):
            return self._execute()

    def _execute(self):
        from filodb_tpu_torch.query.model import GridResult, RangeParams

        def dial(timeout_s: float) -> bytes:
            # re-encoded per attempt: forward the REMAINING budget
            # (tenant/priority ride fields 13/14 — budget inheritance)
            qctx = qos.current()
            payload = wire.encode_exec_request(
                self.dataset, self.query, self.start_ms, self.step_ms,
                self.end_ms, local_only=self.local_only,
                plan_wire=self.plan_wire,
                deadline_ms=self._deadline_ms(),
                trace_ctx=obs_trace.inject_header() or "",
                no_cache=self.no_cache,
                expect_shards=(self.expect_shards
                               if self.local_only else None),
                tenant=qctx.tenant if qctx is not None else "",
                priority=qctx.priority if qctx is not None else 0)
            return _call(self.addr, "Exec", payload, timeout_s,
                         self.node_id)

        try:
            buf = resilient_call(
                dial, key=self.addr, node_id=self.node_id,
                timeout_s=self.timeout_s, retry=self.retry,
                breakers=self.breakers, deadline=self.deadline)
        except TransportError:
            if self.http_fallback is None:
                raise
            # the HTTP edge can't carry a structural plan; only PromQL-
            # printable pushdowns downgrade (the planner only sets
            # http_fallback when a query string exists)
            _note_fallback(self.fallbacks, self.node_id)
            return self._fallback_exec().execute()
        steps, keys, values, hv, les, stats, error = \
            wire.decode_exec_response(buf)
        obs_trace.absorb_wire(stats.get("trace_spans"))
        if error:
            _raise_peer_error(self.node_id, error)
        partial = bool(stats.get("partial"))
        warnings = list(stats.get("warnings") or ())
        if self.stats is not None:
            self.stats.series_scanned += stats.get("seriesScanned", 0)
            self.stats.samples_scanned += stats.get("samplesScanned", 0)
            # degraded peer: keep the markers flowing exactly like the
            # HTTP plane (prom_json.attach_degraded reads these)
            self.stats.partial = self.stats.partial or partial
            self.stats.warnings.extend(
                w for w in warnings if w not in self.stats.warnings)
        # align the peer's grid onto the local step grid (identical for
        # range queries; instant queries return a single step)
        params = RangeParams(self.start_ms, self.step_ms, self.end_ms)
        want = params.steps
        if steps.size == want.size and np.array_equal(steps, want):
            return GridResult(want, keys, values, hist_values=hv,
                              bucket_les=les, partial=partial,
                              warnings=warnings)
        out = np.full((len(keys), want.size), np.nan)
        idx = np.searchsorted(want, steps)
        ok = (idx < want.size) & (want[np.clip(idx, 0, want.size - 1)]
                                  == steps)
        out[:, idx[ok]] = values[:, ok]
        # realign histogram columns with the same mapping (dropping them
        # while keeping bucket_les would hand downstream ops an
        # inconsistent grid)
        hv_out = None
        if hv is not None:
            hv_out = np.full((hv.shape[0], want.size, hv.shape[2]),
                             np.nan)
            hv_out[:, idx[ok], :] = hv[:, ok, :]
        return GridResult(want, keys, out, hist_values=hv_out,
                          bucket_les=les if hv_out is not None else None,
                          partial=partial, warnings=warnings)

    def plan_tree(self, indent: int = 0) -> str:
        return (" " * indent + f"GrpcRemoteExec(node={self.node_id}, "
                f"query={self.query!r})")
