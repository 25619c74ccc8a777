"""Multi-process cluster plane of the port (the counterpart of
``filodb_tpu.parallel.cluster``): peer addressing, remote leaf dispatch,
and failure detection.

The analogue of FiloDB's v2 cluster mode
(coordinator/v2/FiloDbClusterDiscovery.scala:50 — deterministic
ordinal→shards, no cluster singleton) + plan dispatch
(query/exec/PlanDispatcher.scala:21, RemoteActorPlanDispatcher): each node
owns `shards_for_ordinal(ordinal)`; a query entering any node fans its
LEAF data selection out to the peers owning the other shards over plain
HTTP or gRPC (bulk device compute stays node-local), and the full plan
evaluates on the entry node over the merged series, through the entry
node's own tiles and kernels. Node
loss is detected by health polling (Akka gossip/DeathWatch equivalent,
FilodbCluster.scala): the lost node's shards flip DOWN, and past the
quorum-gated grace window survivors ADOPT them (ShardManager.scala:28
assignShardsToNodes). Planned topology changes — rolling-restart drain
and rejoin hand-back — run the make-before-break handoff protocol in
parallel/membership.py instead of the crash machinery, with topology
epochs and stale-routing retries keeping peer routing coherent.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.parallel.resilience import (BreakerRegistry,
                                                  Deadline, RetryPolicy,
                                                  TransportError,
                                                  resilient_call)
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, ShardStatus
from filodb_tpu_torch.query.model import (QueryError, RawSeries,
                                          StaleRoutingError)
from filodb_tpu_torch.testing import chaos


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _unb64(s: str, dtype, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype).reshape(shape)


def series_to_wire(series: Sequence[RawSeries]) -> List[Dict]:
    """RawSeries → JSON-safe dicts. Arrays ride base64 (bit-exact — JSON
    floats can't carry NaN); the reference ships SerializedRangeVector
    containers over Kryo for the same reason (RangeVector.scala:452)."""
    out = []
    for s in series:
        d = {
            "labels": dict(s.labels),
            "n": int(s.ts.size),
            "ts": _b64(s.ts.astype(np.int64)),
            "values": _b64(np.asarray(s.values, dtype=np.float64)),
            "is_counter": bool(s.is_counter),
        }
        if s.values.ndim == 2:
            d["nb"] = int(s.values.shape[1])
        if s.bucket_les is not None:
            d["les"] = [float(x) for x in np.asarray(s.bucket_les)]
        if s.hist_drop_rows is not None:
            d["drops"] = _b64(np.asarray(s.hist_drop_rows,
                                         dtype=np.int64))
        if s.snapshot_key is not None:
            d["snap"] = list(s.snapshot_key)
            d["chunk_len"] = int(s.chunk_len)
        out.append(d)
    return out


def wire_to_series(rows: Sequence[Dict]) -> List[RawSeries]:
    out = []
    for d in rows:
        n = d["n"]
        shape = (n, d["nb"]) if "nb" in d else (n,)
        les = np.array(d["les"], dtype=np.float64) if "les" in d else None
        drops = _unb64(d["drops"], np.int64, (-1,)) if "drops" in d \
            else None
        out.append(RawSeries(
            labels=d["labels"],
            ts=_unb64(d["ts"], np.int64, (n,)),
            values=_unb64(d["values"], np.float64, shape),
            is_counter=d["is_counter"],
            bucket_les=les,
            hist_drop_rows=drops,
            snapshot_key=tuple(d["snap"]) if "snap" in d else None,
            chunk_len=int(d.get("chunk_len", -1)),
        ))
    return out


def _get_json(url_or_req, node_id: str, timeout_s: float) -> Dict:
    """Fetch + parse a peer response, mapping transport errors to
    TransportError (retryable, breaker-counted) and peer application
    errors to QueryError (shared by leaf dispatch and whole-query
    forwarding)."""
    url = getattr(url_or_req, "full_url", url_or_req)
    try:
        chaos.fire("http.peer", node=node_id, url=url)
        with urllib.request.urlopen(url_or_req, timeout=timeout_s) as r:
            payload = json.loads(r.read())
    except (OSError, ValueError) as e:      # ValueError: garbled body
        raise TransportError(f"remote node {node_id} unreachable: {e}")
    if payload.get("status") != "success":
        if payload.get("errorType") == "stale_routing":
            # the peer no longer serves the shards we routed at it (a
            # planned handoff moved them): NOT retryable against the
            # same peer — the entry node re-resolves routing instead
            raise StaleRoutingError(
                owners=payload.get("owners"),
                epoch=int(payload.get("topo_epoch") or 0),
                node=node_id, detail=str(payload.get("error") or ""))
        sr = StaleRoutingError.parse(payload.get("error"))
        if sr is not None:
            raise sr
        raise QueryError(f"remote node {node_id}: {payload.get('error')}")
    return payload


def _drop_grpc_channel(addr: str) -> None:
    """Close + evict a cached gRPC channel (peer died or moved ports);
    no-op when grpc isn't installed or nothing is cached."""
    try:
        from filodb_tpu_torch.grpcsvc.client import drop_channel
        drop_channel(addr)
    except Exception:
        pass


def filters_to_wire(filters: Sequence[ColumnFilter]) -> List[List[str]]:
    return [[f.label, f.op, f.value] for f in filters]


def wire_to_filters(rows: Sequence[Sequence[str]]) -> List[ColumnFilter]:
    return [ColumnFilter(l, op, v) for l, op, v in rows]


class RemoteShardGroup:
    """Stands in a planner shard list for ONE peer node's shard subset.

    `select_raw_series` recognizes it and delegates the leaf data fetch to
    the peer's POST /api/v1/raw/{dataset} endpoint — the ActorPlanDispatcher
    leaf-dispatch hop, over HTTP instead of Akka+Kryo.

    Transport failures retry per ``retry`` within the ``deadline``
    budget; consecutive failures trip the peer's circuit breaker in
    ``breakers`` (keyed by base URL). With ``allow_partial`` the caller
    (select_raw_series) drops this group from the result and records a
    warning instead of failing the query."""

    def __init__(self, node_id: str, base_url: str, dataset: str,
                 shard_nums: Optional[Sequence[int]],
                 timeout_s: float = 60.0,
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 deadline: Optional[Deadline] = None,
                 allow_partial: bool = False):
        self.node_id = node_id
        self.base_url = base_url.rstrip("/")
        self.dataset = dataset
        # None = ALL of the peer's shards (cross-cluster raw reads)
        self.shard_nums = list(shard_nums) if shard_nums is not None \
            else None
        self.timeout_s = timeout_s
        self.retry = retry
        self.breakers = breakers
        self.deadline = deadline
        self.allow_partial = allow_partial
        # planner bookkeeping: a group covers many shard numbers
        self.shard_num = tuple(self.shard_nums or ())

    def describe(self) -> str:
        """Human-readable identity for partial-result warnings."""
        sh = ("all" if self.shard_nums is None
              else ",".join(map(str, self.shard_nums)))
        return f"shards [{sh}] on {self.node_id}"

    def fetch_raw(self, filters, start_ms: int, end_ms: int,
                  column: Optional[str],
                  full: bool = True) -> List[RawSeries]:
        msg = {
            "filters": filters_to_wire(filters),
            "start_ms": int(start_ms), "end_ms": int(end_ms),
            "column": column, "shards": self.shard_nums,
            "full": bool(full),
        }
        # tenant QoS: the fan-out leg inherits the entry query's tenant
        # charge (the peer force-debits its own bucket for this tenant)
        # and priority class (its batcher orders the leg accordingly)
        qctx = qos.current()
        if qctx is not None:
            msg["tenant"] = qctx.tenant
            if qctx.priority:
                msg["priority"] = qctx.priority

        def dial(timeout_s: float) -> Dict:
            # server-side deadline propagation: the peer inherits the
            # entry node's REMAINING budget (re-read per attempt — a
            # retry must not hand the peer the original full budget)
            if self.deadline is not None:
                msg["timeout_s"] = round(
                    max(self.deadline.remaining(), 1e-3), 3)
            body = json.dumps(msg).encode()
            headers = {"Content-Type": "application/json"}
            tb = obs_trace.inject_header()
            if tb:      # trace propagation on the JSON control plane
                headers[obs_trace.HEADER] = tb
            req = urllib.request.Request(
                f"{self.base_url}/api/v1/raw/{self.dataset}", data=body,
                headers=headers)
            return _get_json(req, self.node_id, timeout_s)

        with obs_trace.span("remote-peer", node=self.node_id,
                            plane="http", rpc="raw",
                            addr=self.base_url):
            payload = resilient_call(
                dial, key=self.base_url, node_id=self.node_id,
                timeout_s=self.timeout_s, retry=self.retry,
                breakers=self.breakers, deadline=self.deadline)
            obs_trace.absorb_spans(payload.get("trace_spans"))
        return wire_to_series(payload["data"])

    # metadata plans are answered via the HTTP layer's peer fan-out, not
    # through this leaf-dispatch path
    def lookup_partitions(self, filters, start_ts, end_ts):
        return []


class PromQlRemoteExec:
    """Forward a WHOLE query to the peer node owning every involved shard
    and parse its Prometheus JSON back into a grid
    (query/exec/PromQlRemoteExec.scala — HTTP JSON to a remote FiloDB).

    This is the shard-aligned pushdown: when a plan (including a binary
    join whose two sides prune to the same shard set) lives entirely on
    one peer, the peer evaluates it — windowing, joins, aggregation — and
    only the final result crosses the network, not raw series."""

    def __init__(self, query: str, start_ms: int, step_ms: int,
                 end_ms: int, node_id: str, base_url: str, dataset: str,
                 timeout_s: float = 60.0, stats=None,
                 local_only: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 deadline: Optional[Deadline] = None,
                 no_cache: bool = False,
                 expect_shards: Optional[Sequence[int]] = None):
        self.query = query
        self.start_ms = start_ms
        self.step_ms = step_ms
        self.end_ms = end_ms
        self.node_id = node_id
        self.base_url = base_url.rstrip("/")
        self.dataset = dataset
        self.timeout_s = timeout_s
        self.stats = stats      # planner QueryStats: peer stats fold in
        # the shard set the entry node believes this peer owns: the
        # peer bounces the query (stale_routing) instead of silently
        # evaluating over a subset when a handoff moved one away
        self.expect_shards = list(expect_shards) \
            if expect_shards is not None else None
        # pushdown within a cluster pins the peer to its local shards;
        # cross-cluster federation lets the remote cluster plan freely
        # (MultiPartitionPlanner semantics)
        self.local_only = local_only
        self.retry = retry
        self.breakers = breakers
        self.deadline = deadline
        # the caller's &cache=false rides the hop: the peer must not
        # serve this query from its results cache either
        self.no_cache = no_cache

    def execute(self):
        import urllib.parse

        from filodb_tpu_torch.query.model import GridResult, RangeParams
        params = RangeParams(self.start_ms, self.step_ms, self.end_ms)
        steps = params.steps
        instant = self.step_ms <= 0
        if instant:
            qs = {"query": self.query, "time": self.start_ms // 1000}
            path = "query"
        else:
            qs = {"query": self.query, "start": self.start_ms // 1000,
                  "end": self.end_ms // 1000,
                  "step": self.step_ms // 1000}
            path = "query_range"
        if self.local_only:
            qs["dispatch"] = "local"    # no fan-back-out (loop prevention)
            if self.expect_shards:
                qs["expect_shards"] = ",".join(
                    str(int(s)) for s in self.expect_shards)
        if self.no_cache:
            qs["cache"] = "false"
        # tenant QoS: pushdown/federation hops name the tenant so the
        # peer charges the same budget (forced on dispatch=local hops;
        # a federation peer applies its own edge admission)
        qctx = qos.current()
        if qctx is not None:
            qs["tenant"] = qctx.tenant
            if qctx.priority:
                qs["priority"] = qos.PRIORITY_NAMES.get(
                    qctx.priority, "interactive")
        qs["hist-wire"] = "1"

        def dial(t: float) -> Dict:
            # forward the remaining deadline budget so the peer's own
            # evaluation inherits it (&timeout=, the knob the HTTP edge
            # already parses); re-read per attempt
            if self.deadline is not None:
                qs["timeout"] = "%.3fs" % max(self.deadline.remaining(),
                                              1e-3)
            url = (f"{self.base_url}/promql/{self.dataset}/api/v1/"
                   f"{path}?" + urllib.parse.urlencode(qs))
            tb = obs_trace.inject_header()
            if tb:      # trace propagation on the HTTP pushdown plane
                url = urllib.request.Request(
                    url, headers={obs_trace.HEADER: tb})
            return _get_json(url, self.node_id, t)

        with obs_trace.span("remote-peer", node=self.node_id,
                            plane="http", rpc="exec",
                            addr=self.base_url):
            payload = resilient_call(
                dial, key=self.base_url, node_id=self.node_id,
                timeout_s=self.timeout_s, retry=self.retry,
                breakers=self.breakers, deadline=self.deadline)
            obs_trace.absorb_spans(payload.get("trace_spans"))
        if self.stats is not None and "stats" in payload:
            self.stats.series_scanned += payload["stats"].get(
                "seriesScanned", 0)
            self.stats.samples_scanned += payload["stats"].get(
                "samplesScanned", 0)
        data = payload["data"]
        keys, rows, hrows, les = [], [], [], None
        any_hist = False
        for entry in data.get("result", []):
            keys.append(dict(entry["metric"]))
            row = np.full(steps.size, np.nan)
            samples = entry.get("values")
            if samples is None and "value" in entry:
                samples = [entry["value"]]
            for t, v in samples or []:
                pos = np.searchsorted(steps, int(float(t) * 1000))
                if pos < steps.size and steps[pos] == int(float(t) * 1000):
                    row[pos] = float(v)
            rows.append(row)
            h = entry.get("hist")
            if h is not None:
                any_hist = True
                les = np.array(h["les"], dtype=np.float64)
                hrows.append(_unb64(h["values"], np.float64,
                                    (steps.size, les.size)))
            else:
                hrows.append(None)
        values = np.vstack(rows) if rows else np.zeros((0, steps.size))
        hv = None
        if any_hist:
            nb = les.size
            hv = np.stack([h if h is not None
                           else np.full((steps.size, nb), np.nan)
                           for h in hrows])
        # a degraded peer answers with partial/warnings markers: carry
        # them through so the entry node's response stays honest
        return GridResult(steps, keys, values, hist_values=hv,
                          bucket_les=les if any_hist else None,
                          partial=bool(payload.get("partial")),
                          warnings=list(payload.get("warnings") or ()))

    def plan_tree(self, indent: int = 0) -> str:
        return (" " * indent + f"PromQlRemoteExec(node={self.node_id}, "
                f"query={self.query!r})")


def reassign_dead_shards(dead_shards: Sequence[int],
                         survivors: Sequence[str]) -> Dict[int, str]:
    """Deterministic round-robin of a dead node's shards over the sorted
    survivor set (ShardAssignmentStrategy.scala:188 — every node computes
    the same table independently, no coordinator election needed)."""
    ordered = sorted(survivors)
    return {sh: ordered[i % len(ordered)]
            for i, sh in enumerate(sorted(dead_shards))}


class FailureDetector:
    """Health-poll peers; flip their shards DOWN after consecutive misses
    and back ACTIVE on recovery (the Akka-cluster gossip/DeathWatch +
    ShardManager reaction, ShardManager.scala:28).

    With ``reassign_grace_s`` set, a node held DOWN past the grace window
    triggers ``on_node_down(node)`` exactly once — the server's elastic
    recovery hook (ShardManager.scala:28 assignShardsToNodes +
    ShardAssignmentStrategy.scala:188): survivors adopt the dead node's
    shards deterministically. When the node comes back, ``on_node_up``
    runs instead of the plain ACTIVE flip so adopters can release."""

    def __init__(self, mapper: ShardMapper, peers: Dict[str, str],
                 shards_by_node: Dict[str, Sequence[int]],
                 interval_s: float = 0.5, threshold: int = 3,
                 timeout_s: float = 2.0,
                 reassign_grace_s: Optional[float] = None,
                 on_node_down=None, on_node_up=None,
                 grpc_peer_sink: Optional[Dict[str, str]] = None,
                 peer_state_sink: Optional[Dict[str, Dict]] = None):
        self.mapper = mapper
        self.peers = dict(peers)
        # mutable {node -> "host:port"} the poller fills from peers'
        # advertised gRPC ports (shared with the planner's grpc_peers,
        # so leaf dispatch upgrades to the binary data plane as soon as
        # a peer is discovered)
        self.grpc_peer_sink = grpc_peer_sink
        # mutable {node -> {"watermarks": {shard: ms}, "epochs":
        # {shard: n}, "topo_epoch": n}} filled from peers' health
        # bodies (ROADMAP 4a): the planner stamps remote shard groups
        # with gossiped ingest watermarks + backfill epochs so the
        # results cache's freshness horizon covers fan-out extents too.
        # Entries are dropped the moment a peer goes down — a stale
        # advertisement must not bound freshness.
        self.peer_state_sink = peer_state_sink
        # set by stop() when the monitor thread failed to exit within
        # the join timeout; surfaced as the detector_thread_wedged
        # gauge so chaos runs can't silently leak pollers
        self.thread_wedged = False
        self.shards_by_node = {k: list(v) for k, v in
                               shards_by_node.items()}
        self.interval_s = interval_s
        self.threshold = threshold
        self.timeout_s = timeout_s
        self.reassign_grace_s = reassign_grace_s
        self.on_node_down = on_node_down
        self.on_node_up = on_node_up
        self._misses: Dict[str, int] = {p: 0 for p in peers}
        self._down: Dict[str, bool] = {p: False for p in peers}
        self._down_since: Dict[str, float] = {}
        self._reassigned: Dict[str, bool] = {p: False for p in peers}
        # status gossip parsed from peers' health bodies: each peer
        # advertises the FSM status of the shards it actually serves,
        # and its own down-view of ITS peers (the quorum input)
        self._peer_shards: Dict[str, Dict[int, str]] = {}
        self._peer_down_view: Dict[str, set] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _probe(self, url: str) -> Optional[Dict]:
        """One health poll: {} on a healthy peer without a parseable
        body, the parsed body when present, None when unreachable."""
        try:
            with urllib.request.urlopen(f"{url.rstrip('/')}/__health",
                                        timeout=self.timeout_s) as r:
                if r.status != 200:
                    return None
                try:
                    return json.loads(r.read())
                except ValueError:
                    return {}
        except OSError:
            return None

    def note_peer_exit(self, node: str) -> None:
        """Supervisor-bus hint: a sibling worker PROCESS exited (the
        supervisor waitpid'd it — ground truth, no probe needed). Drop
        the peer's data-plane channel and its gossiped watermarks
        immediately instead of waiting out poll misses: a dead worker's
        stale watermark advertisement must not keep bounding the
        results cache's freshness horizon while it restarts. Routing is
        deliberately NOT flipped DOWN here — the supervisor is already
        respawning the worker at the same address, so in-flight peer
        calls ride their retry budget through the restart window."""
        if node not in self.peers:
            return
        if self.grpc_peer_sink is not None:
            old = self.grpc_peer_sink.pop(node, None)
            if old is not None:
                _drop_grpc_channel(old)
        if self.peer_state_sink is not None:
            self.peer_state_sink.pop(node, None)

    def note_peer_up(self, node: str) -> None:
        """Supervisor-bus hint: a sibling worker finished restarting.
        Reset the miss counter so one stale in-flight probe can't push
        the fresh process over the down threshold."""
        if node in self._misses:
            self._misses[node] = 0

    def is_down(self, node: str) -> bool:
        return self._down.get(node, False)

    def alive_peers(self) -> List[str]:
        return [p for p in self.peers if not self._down.get(p, False)]

    def down_peers(self) -> List[str]:
        """This node's own down-view (advertised in its health body so
        peers can count quorum votes)."""
        return [p for p, d in self._down.items() if d]

    def _quorum_agrees(self, node: str) -> bool:
        """Require a majority of this node's OTHER alive peers to share
        the down-view before elastic reassignment fires — one node's
        partitioned link must not trigger dual-ingest adoption (the
        Akka-cluster gossip-convergence analogue, FilodbCluster.scala).
        With no other alive peer there is no quorum to consult."""
        voters = [p for p in self.peers
                  if p != node and not self._down.get(p, False)]
        if not voters:
            return True
        agree = sum(1 for p in voters
                    if node in self._peer_down_view.get(p, ()))
        # self + agreeing peers must be a strict majority of self + voters
        return 2 * (1 + agree) > 1 + len(voters)

    def _sync_peer_statuses(self, node: str, adv: Dict[int, str]) -> None:
        """Adopt the owner's advertised shard statuses instead of
        guessing: a shard another survivor adopted stays RECOVERY on
        every node until its owner advertises it ACTIVE (closes the
        window where queries hit a bootstrapping adopter and silently
        return partial results)."""
        for sh, st_str in adv.items():
            if self.mapper.node_of(sh) != node:
                continue
            try:
                st = ShardStatus(st_str)
            except ValueError:
                continue
            if self.mapper.status(sh) is not st:
                self.mapper.update(sh, st, node)

    @staticmethod
    def _int_map(raw) -> Dict[int, object]:
        try:
            return {int(k): v for k, v in (raw or {}).items()}
        except (TypeError, ValueError):
            return {}

    def poll_once(self) -> None:
        for node, url in self.peers.items():
            body = self._probe(url)
            if body is not None:
                self._misses[node] = 0
                adv = self._int_map(body.get("shards"))
                self._peer_shards[node] = adv
                self._peer_down_view[node] = set(
                    body.get("down_peers") or ())
                if self.peer_state_sink is not None:
                    # watermark/epoch gossip (ROADMAP 4a): the planner
                    # reads this to stamp remote shard groups for the
                    # results cache's freshness horizon
                    self.peer_state_sink[node] = {
                        "watermarks": self._int_map(
                            body.get("watermarks")),
                        "epochs": self._int_map(
                            body.get("backfill_epochs")),
                        "topo_epoch": int(body.get("topo_epoch") or 0),
                    }
                gport = body.get("grpc_port")
                if gport and self.grpc_peer_sink is not None:
                    host = urllib.parse.urlparse(url).hostname \
                        or "127.0.0.1"
                    addr = f"{host}:{int(gport)}"
                    old = self.grpc_peer_sink.get(node)
                    if old != addr:
                        # a restarted peer advertises a NEW ephemeral
                        # port: re-point the sink and drop the cached
                        # channel to the dead address, or every later
                        # dial would keep hitting it (round-5 advisor)
                        self.grpc_peer_sink[node] = addr
                        if old is not None:
                            _drop_grpc_channel(old)
                came_back = self._down[node]
                if came_back:
                    self._down[node] = False
                    self._down_since.pop(node, None)
                if self._reassigned.get(node, False):
                    # the node is healthy but its shards are still
                    # reassigned away. Run the release hook; only a
                    # SUCCESSFUL hook clears the flag, so a raising
                    # hook is retried on the next poll instead of
                    # wedging ownership on the adopters forever
                    if self.on_node_up is not None:
                        try:
                            self.on_node_up(node)
                            self._reassigned[node] = False
                            continue
                        except Exception:
                            # fall through to the mapper-level hand-
                            # back below (ownership must not wedge);
                            # the hook retries next poll
                            pass
                    else:
                        self._reassigned[node] = False
                    hand_back = list(self.shards_by_node.get(node, []))
                elif came_back:
                    # plain bounce (no reassignment fired): restore
                    # only what the mapper STILL assigns to the node —
                    # a planned handoff may have rewired ownership
                    # while it was away, and a drained node owns none
                    hand_back = list(self.mapper.shards_for_node(node))
                else:
                    self._sync_peer_statuses(node, adv)
                    continue
                for sh in hand_back:
                    # honor what the returning node ADVERTISES: a
                    # node mid-replay says "recovery" and must not
                    # be flipped ACTIVE (queries would lose the
                    # partial-result warning until the next poll)
                    try:
                        st = ShardStatus(adv[sh]) if sh in adv \
                            else ShardStatus.ACTIVE
                    except ValueError:
                        st = ShardStatus.ACTIVE
                    self.mapper.update(sh, st, node)
            else:
                self._misses[node] += 1
                if self._misses[node] >= self.threshold \
                        and not self._down[node]:
                    self._down[node] = True
                    self._down_since[node] = time.monotonic()
                    # flip the shards the mapper assigns the node NOW
                    # (not the startup assignment): planned handoffs
                    # rewire ownership, and a drained node owns nothing
                    for sh in self.mapper.shards_for_node(node):
                        self.mapper.update(sh, ShardStatus.DOWN, node)
                    # forget the dead node's data-plane address: when it
                    # returns (likely on a new ephemeral port) the sink
                    # re-learns from its fresh health advertisement
                    # instead of dialing the dead address forever
                    if self.grpc_peer_sink is not None:
                        old = self.grpc_peer_sink.pop(node, None)
                        if old is not None:
                            _drop_grpc_channel(old)
                    # a dead peer's gossiped watermarks must not keep
                    # bounding the results cache's freshness horizon
                    if self.peer_state_sink is not None:
                        self.peer_state_sink.pop(node, None)
                if (self._down[node] and self.reassign_grace_s is not None
                        and not self._reassigned.get(node, False)
                        and time.monotonic() - self._down_since[node]
                        >= self.reassign_grace_s
                        and self._quorum_agrees(node)):
                    self._reassigned[node] = True
                    if self.on_node_down is not None:
                        try:
                            self.on_node_down(node)
                        except Exception:
                            pass     # keep the monitor thread alive

    @thread_root("failure-detector")
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.poll_once()

    def start(self) -> "FailureDetector":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="failure-detector")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # the monitor thread failed to exit (a health probe
                # wedged past its timeout, or a hook hung): surface it
                # — chaos runs must not silently leak pollers. The
                # /metrics gauge detector_thread_wedged rides this.
                self.thread_wedged = True
                import sys
                print(f"filodb: FailureDetector monitor thread failed "
                      f"to exit within 5s (peers={sorted(self.peers)})",
                      file=sys.stderr)
