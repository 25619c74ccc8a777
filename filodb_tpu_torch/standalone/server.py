"""FiloServer of the port: the standalone node binary (the counterpart of
``filodb_tpu.standalone.server``).

Wires config -> column store -> memstore shards (bootstrapped from it) ->
shard mapper -> TorchBackend (with its micro-batcher) -> HTTP API -> gRPC
query service -> failure detector and membership -> durable streams,
ingestion drivers and the influx gateway, mirroring the v2 startup path
(standalone/NewFiloServerMain.scala:21: start memstore, discovery,
ingestion, http).

In a cluster (``num-nodes`` > 1, ``node-ordinal``, ``peers`` or
``discovery``) the node owns ``shards_for_ordinal(ordinal)``, reads the
other shards from their owners over gRPC (``grpc-port``, on by default as
in the reference; its address is gossiped through the health body) or
HTTP, detects dead peers, adopts their shards after
``shard-reassign-grace-s`` and hands its own off on ``POST /admin/drain``.

Under the supervisor (``standalone/supervisor.py``) the node is one worker
process: ``worker-id`` is its ordinal, it accepts on the shared public port
(``accept-port`` with SO_REUSEPORT, or the inherited ``accept-fd``) beside
its private port, and its control-plane client (``bus-port``) publishes its
topology transitions and watermarks to its siblings and applies theirs,
the supervisor's schema invalidations and worker lifecycle hints (a
sibling's exit or return re-elects the rule evaluator).

With ``self-monitor`` the node ingests its own metrics into the reserved
``__selfmon__`` dataset; with ``rules`` or ``rules-file`` it evaluates
Prometheus rule groups through its own serving path (and so through the
device kernels), writes recorded series and alert state into
``__rules__`` and serves ``/api/v1/rules`` and ``/api/v1/alerts``.

The backend runs on the CUDA device unless the config's ``device`` names
another one (``"cpu"`` for tests); without a card :meth:`FiloServer.start`
raises. The server never falls back to the numpy oracle.

Config keys follow the JAX package's ``DEFAULTS``, and each of them lands
in exactly one place: honoured (``DEFAULTS`` here), refused with a
``ValueError`` in ``__init__`` when its value turns on a module the port
does not have yet (``REFUSED``, with the ROADMAP item that ports it), or
accepted with no effect, with the reason (``INERT``). So no setting is
silently ignored.

    python -m filodb_tpu_torch.standalone.server --seed-dev-data [--device cpu]
    python -m filodb_tpu_torch.standalone.server --data-dir D --stream-dir S \
        --gateway-port 0 [--device cpu]
    python -m filodb_tpu_torch.standalone.server --seed-dev-data \
        --self-monitor --rules-file rules.yaml
    python -m filodb_tpu_torch.standalone.server --config node1.json
        (node1.json: {"num-nodes": 2, "node-ordinal": 1, "peers":
        {"node0": "http://127.0.0.1:8080"}, "port": 8081, ...})
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional

from filodb_tpu_torch.core.cardinality import CardinalityTracker
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.metering import TenantMetering
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.core.spread import SpreadProvider
from filodb_tpu_torch.gateway.server import GatewayServer
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.ingest.driver import IngestionDriver
from filodb_tpu_torch.ingest.stream import LogIngestionStream
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs.process import register_process_collector
from filodb_tpu_torch.obs.trace import TraceExporter, Tracer
from filodb_tpu_torch.parallel.resilience import (BreakerRegistry,
                                                  PeerResilience,
                                                  RetryPolicy)
from filodb_tpu_torch.parallel.shardmapper import (ShardMapper, ShardStatus,
                                                   assign_shards_evenly,
                                                   shards_for_ordinal)
from filodb_tpu_torch.query.batcher import MicroBatcher
from filodb_tpu_torch.query.model import QueryLimits
from filodb_tpu_torch.query.qos import TenantBudgets
from filodb_tpu_torch.store import FlatFileColumnStore

DEFAULTS = {
    "dataset": "timeseries",
    "num-shards": 4,
    "groups-per-shard": 8,
    "max-chunks-size": 400,
    "port": 8080,
    "node-id": "node0",
    # the torch device of the backend; None = the CUDA device
    "device": None,
    # spread used for shard-key routing (filodb-defaults.conf:319
    # default-spread); must match the ingest-side spread
    "default-spread": 1,
    # chunk/partkey/checkpoint persistence root (store/columnstore.py);
    # None = memory-only
    "data-dir": None,
    # per-shard durable stream logs (ingest/stream.py, the Kafka
    # partition analogue) drained by one ingestion driver per shard;
    # None = no streaming ingestion (direct ingest only)
    "stream-dir": None,
    # influx line-protocol ingest edge (gateway/server.py; needs
    # stream-dir); None = off, 0 = ephemeral port
    "gateway-port": None,
    # flush cadence: one flush group every interval, rotating
    # round-robin, or every this-many stream records (None = by time)
    "flush-interval-s": 2.0,
    "flush-every-records": None,
    # raw retention in seconds; queries reaching further back split to the
    # downsample tier (LongTimeRangePlanner). Requires data-dir (the ds
    # tier reads downsampler-job output from the ColumnStore). None = off.
    "raw-retention-s": None,
    # downsample resolutions in ms (conf multi-resolution config)
    "downsample-resolutions": [300_000, 3_600_000],
    # emit downsample records during flush (ShardDownsampler.scala:40);
    # requires data-dir. The batch job remains for backfill + histograms.
    "flush-downsample": False,
    # per-shard resident-sample budget; exceeded -> evict least-recently
    # written partitions to ODP shells (with data-dir) or drop them
    # (memory-only). 0 = no cap.
    "max-resident-samples": 0,
    # stream read batch per ingest poll; also the recovery replay batch
    "ingest-batch-records": 64,
    # host decode/merge cache byte budget per shard (0 = unbounded),
    # trimmed on the flush path
    "decode-cache-mb": 0,
    # group-commit fsync of the durable streams: appends fsync at most
    # every this-many ms (or 1 MB unsynced); 0 = fsync per append, the
    # strict acknowledgement guarantee
    "stream-group-commit-ms": 5.0,
    # quarantined-record loss a shard tolerates before it degrades to
    # read-only (queries keep serving); 0 = any quarantined record
    "integrity-max-quarantined-records": 0,
    # per-tenant cardinality gauges published on a timer
    # (TenantIngestionMetering.scala; 0 = off)
    "tenant-metering-interval-s": 60,
    # serving-path GC hygiene at the end of start(): collect, freeze the
    # start-up object graph and make full collections rarer
    "gc-freeze": True,
    # sys.setswitchinterval in ms for the serving threads; None = the
    # interpreter's default
    "gil-switch-interval-ms": None,
    # per-query guardrails (filodb-defaults.conf sample-limit equivalent;
    # 0 = unlimited). Over-limit queries return HTTP 422.
    "query-sample-limit": 1_000_000,
    "query-series-limit": 100_000,
    # degraded-mode execution (parallel/resilience.py): default per-query
    # deadline budget (overridable per request via &timeout=), bounded
    # retries on peer transport failures, and per-peer circuit breakers
    # (open after N consecutive failures; half-open probe after the
    # reset window). Partial responses stay opt-in per request
    # (&allow_partial=true).
    "query-timeout-s": 30.0,
    "peer-retry-attempts": 3,
    "peer-retry-base-delay-s": 0.05,
    "breaker-failure-threshold": 3,
    "breaker-reset-s": 5.0,
    # multi-process cluster (FiloDbClusterDiscovery.scala:50
    # ordinal->shards; explicit peer list like the akka-bootstrapper's
    # explicit-list mode): this node owns shards_for_ordinal(node-ordinal);
    # peers maps node ids ("node0"...) -> base URLs for leaf dispatch
    "num-nodes": 1,
    "node-ordinal": 0,
    "peers": {},
    # seed discovery (parallel/discovery.py) when "peers" is empty:
    #   {"mode": "dns-srv", "srv-name": "_filodb._tcp.ns.svc"} or
    #   {"mode": "consul", "url": "http://consul:8500", "service": "filodb"}
    # "advertise-url" identifies THIS node among the discovered seeds
    # (ordinals follow the sorted seed list on every node)
    "discovery": None,
    "advertise-url": None,
    # HA buddy replica cluster (HighAvailabilityPlanner.scala:31): node id
    # -> the SAME-ordinal node of a replica cluster ingesting the same
    # streams; queries route a DOWN node's shards to its buddy
    "buddy-peers": {},
    # cross-cluster federation: _ws_ value -> base URL of the cluster
    # owning that workspace (MultiPartitionPlanner.scala:53); workspaces
    # in local-partitions are served here and never forwarded
    "partitions": {},
    "local-partitions": [],
    "failure-detect-interval-s": 0.5,
    "failure-detect-threshold": 3,
    # gRPC query service port (PromQLGrpcServer.scala; 0 = ephemeral,
    # None = off). ON by default, as in the reference: leaf dispatch and
    # pushdown ride protobuf + NibblePack over persistent channels;
    # base64-JSON HTTP remains the control plane and the fallback. Fixed
    # peer addresses via "grpc-peers" {node_id: "host:port"}; otherwise
    # each node advertises its port in its health body and peers learn
    # it through the failure detector's gossip. Needs grpcio.
    "grpc-port": 0,
    "grpc-peers": {},
    "grpc-partitions": {},
    # elastic recovery (ShardManager.scala:28): a peer DOWN this many
    # seconds past detection has its shards adopted by the survivors
    # (bootstrap from the column store, replay the stream from the
    # checkpoint). None = survive-only. Needs the shared data-dir /
    # stream-dir deployment.
    "shard-reassign-grace-s": None,
    # elastic membership (parallel/membership.py): POST /admin/drain
    # hands this node's shards off make-before-break, rejoining nodes
    # defer shards a peer still serves and receive them back through
    # the same protocol. False = the legacy hard cutover on rejoin.
    "elastic-membership": True,
    # per-shard handoff budget (flush + successor replay + ACTIVE
    # advertisement), past which the shard rolls back to its owner
    "handoff-timeout-s": 30.0,
    # metadata/cardinality peer fan-out concurrency (0 = auto from the
    # host's core count)
    "peer-fanout-workers": 0,
    # serving fast path (query/batcher.py + query/plancache.py):
    # residual gather window of the micro-batcher, max queries per device
    # dispatch, and the parsed-plan LRU size (0 disables the plan cache)
    "batch-gather-window-ms": 1.0,
    "batch-max": 8,
    "batch-enabled": True,
    "plan-cache-size": 256,
    # incremental range-query results cache (query/resultcache.py): byte
    # budget (0 disables) and the freshness hot window. Per-request
    # escape hatch: &cache=false.
    "results-cache-mb": 64,
    "results-cache-hot-window-ms": 10_000,
    # tracing is OFF by default (span() stays on its no-op path); queries
    # slower than slow-query-ms leave a record at /debug/slow_queries
    "trace-enabled": False,
    "trace-sample-rate": 1.0,
    "trace-max-traces": 256,
    "slow-query-ms": 1000.0,
    # tail retention threshold; None = slow-query-ms
    "trace-slow-ms": None,
    # OTLP/JSON trace sink (None = off)
    "trace-export-url": None,
    "trace-export-batch": 64,
    "trace-export-interval-s": 2.0,
    "trace-export-queue": 1024,
    # wall-clock sampling profiler (obs/profiler.py): OFF by default (no
    # sampler thread, no metric families); when on, /debug/profile serves
    # folded stacks and top self-time, and
    # filodb_profile_self_seconds_total{root,func} rides the registry
    "profiler-enabled": False,
    "profiler-hz": 29.0,
    "profiler-max-stacks": 4096,
    "profiler-top-n": 20,
    # admission control on the query endpoints: at most this many
    # in-flight evaluations (0 = off); a slot that does not free within
    # admission-wait-s answers 429 + Retry-After
    "max-inflight-queries": 4,
    "admission-wait-s": 5.0,
    # tenant QoS (query/qos.py): per-tenant budgets in estimated cost
    # units/second (0 = off), bucket depth (0 = 10x rate), overrides
    # {tenant: rate | [rate, burst]}, the degrade ladder switch and the
    # coarsen rung's step target
    "qos-tenant-rate": 0,
    "qos-tenant-burst": 0,
    "qos-tenant-overrides": {},
    "qos-shed-degraded": True,
    "qos-degrade-max-steps": 64,
    # per-shard-key spread overrides {"ws,ns": spread}
    "spread-overrides": {},
    # cardinality quotas per prefix depth [root, ws, ns, metric]
    # (0 = unlimited) and per-prefix overrides {"ws,ns": quota}
    "card-default-quotas": [0, 0, 0, 0],
    "card-quotas": {},
    # self-monitoring (obs/selfmon.py): a loop snapshots the metrics
    # registry in-process every interval and ingests it into the reserved
    # __selfmon__ dataset through the normal ingest path (a stream and a
    # driver under stream-dir; direct ingest and a flush every
    # self-monitor-flush-ticks ticks otherwise), queryable as
    # /promql/__selfmon__/api/v1/query_range
    "self-monitor": False,
    "self-monitor-interval-s": 5.0,
    "self-monitor-flush-ticks": 4,
    # recording rules and alerting (rules/): a Prometheus-style YAML or
    # JSON rule file, or the same structure inline ({"groups": [...]}).
    # Groups evaluate in-process as standing queries (background
    # priority, forced charges on the __rules__ tenant, step-aligned
    # tail recomputes of rules-eval-span-steps steps through the results
    # cache); recorded series and ALERTS land in the reserved __rules__
    # dataset; firing and resolved alerts POST to rules-webhook-url
    # (None = no notifications)
    "rules-file": None,
    "rules": None,
    "rules-eval-span-steps": 8,
    "rules-webhook-url": None,
    # process-sharded serving (standalone/supervisor.py), normally derived
    # by the supervisor for each worker process:
    #   worker-id:   this process's worker ordinal (None = standalone)
    #   accept-port: the shared public port, bound here with SO_REUSEPORT
    #                so the kernel balances connections across workers
    #   accept-host: the address accept-port binds
    #   accept-fd:   an inherited listening socket's fd (the fallback
    #                where SO_REUSEPORT is missing: the supervisor binds
    #                once and every worker accepts on the shared socket)
    #   bus-port:    the supervisor's control plane (standalone/bus.py):
    #                topology, schema and watermark events fan out to
    #                every sibling so per-process caches stay coherent
    "worker-id": None,
    "accept-port": None,
    "accept-host": "127.0.0.1",
    "accept-fd": None,
    "bus-port": None,
    # cadence of this worker's watermark/backfill gossip on the bus (the
    # detector's health-body gossip remains the backstop)
    "bus-watermark-interval-s": 0.25,
}

# config keys whose modules are not ported yet -> the ROADMAP item that
# ports them; FiloServer refuses a config whose value turns the feature on
REFUSED = {
    "mesh-enabled": "A.11 mesh and distributed",
    "mesh-tile-serving": "A.11 mesh and distributed",
}

# keys of the JAX package's DEFAULTS that the port accepts at any value
# and that change nothing here -> why. Each only tunes a feature that is
# refused above (so it is off), or acts in the reference only there too.
# None at present: the profiler's keys took effect with obs/profiler.py.
INERT: Dict[str, str] = {}


def _refused(key: str, value, config: Dict) -> bool:
    """Whether ``value`` turns on the unported feature behind ``key``, by
    the reference's own test of that key."""
    if key == "mesh-tile-serving":
        # serves only on the mesh: on when mesh-enabled is on as well
        return bool(value) and bool(config.get("mesh-enabled"))
    return bool(value)


def bind_reuseport(host: str, port: int):
    """A listening socket on (host, port) with SO_REUSEPORT, or None where
    the platform lacks it (the supervisor then binds once and passes the
    fd to every worker)."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return None
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, int(port)))
        s.listen(128)
    except OSError:
        s.close()
        raise
    return s


class FiloServer:
    def __init__(self, config: Optional[Dict] = None,
                 backend: Optional[object] = None):
        config = dict(config or {})
        refused = sorted(k for k, v in config.items()
                         if k in REFUSED and _refused(k, v, config))
        if refused:
            raise ValueError(
                "config keys not ported yet: " + ", ".join(
                    f"{k!r} (ROADMAP {REFUSED[k]})" for k in refused))
        self.config = {**DEFAULTS, **config}
        if self.config.get("gateway-port") is not None \
                and not self.config.get("stream-dir"):
            # the gateway publishes into the stream logs
            raise ValueError("config key 'gateway-port' needs 'stream-dir'")
        self.ref = DatasetRef(self.config["dataset"])
        column_store = None
        if self.config.get("data-dir"):
            column_store = FlatFileColumnStore(self.config["data-dir"])
        self.store = TimeSeriesMemStore(DEFAULT_SCHEMAS,
                                        column_store=column_store)
        self.mapper = ShardMapper(self.config["num-shards"])
        self.backend = backend
        # the server stops the device executor of a backend it built
        self._own_backend = backend is None
        self.http: Optional[FiloHttpServer] = None
        self.node_id: str = self.config["node-id"]
        self.card_trackers: Dict[int, CardinalityTracker] = {}
        # one durable stream per served shard; ONE driver map for
        # primary, adopted and handed-back shards: the per-shard
        # single-writer invariant is "at most one entry here,
        # cluster-wide, per shard"
        self.streams: Dict[int, LogIngestionStream] = {}
        self.drivers: Dict[int, IngestionDriver] = {}
        self.gateway: Optional[GatewayServer] = None
        self.tenant_metering: Optional[TenantMetering] = None
        self.grpc_server = None
        self.detector = None
        self.membership = None
        self.owned_shards: list = []
        # rejoin deferral: ordinal shards a peer still served at start-up
        # (it adopted them while this node was down); created only when
        # the peer hands them back through /admin/adopt
        self.deferred_shards: set = set()
        # elastic-recovery bookkeeping: origin node -> shards THIS node
        # adopted (crash or planned); node -> original assignment
        self._adopted: Dict[str, list] = {}
        self._reassign_lock = threading.Lock()
        self._original_shards: Dict[str, list] = {}
        self._gw_streams: Dict[int, LogIngestionStream] = {}
        # the internal datasets' loops, each with its own stream and
        # driver under stream-dir (None without one)
        self.selfmon = None
        self._selfmon_stream = None
        self._selfmon_driver = None
        self.rules = None
        self._rules_stream = None
        self._rules_driver = None
        # the shared public accept edge's port (None outside a supervisor)
        # and the control-plane client with its watermark-gossip thread
        self.accept_port: Optional[int] = None
        self.bus_client = None
        self._bus_tick_thread: Optional[threading.Thread] = None
        self._bus_tick_stop = threading.Event()

    def _make_qos_budgets(self) -> TenantBudgets:
        """Per-tenant token-bucket budgets from the qos-* knobs (rate 0
        and no overrides = budgets off)."""
        return TenantBudgets(
            default_rate=float(self.config.get("qos-tenant-rate", 0)
                               or 0),
            default_burst=float(self.config.get("qos-tenant-burst", 0)
                                or 0),
            overrides=dict(self.config.get("qos-tenant-overrides")
                           or {}))

    def _make_tracer(self) -> Tracer:
        slow_ms = self.config.get("trace-slow-ms")
        if slow_ms is None:
            # tail retention inherits the slowlog threshold, so every
            # slow-query record links a retained (resolvable) trace
            slow_ms = self.config.get("slow-query-ms", 1000.0)
        exporter = None
        url = self.config.get("trace-export-url")
        if url:
            exporter = TraceExporter(
                str(url),
                batch_max=int(self.config.get("trace-export-batch", 64)),
                interval_s=float(self.config.get(
                    "trace-export-interval-s", 2.0)),
                queue_max=int(self.config.get(
                    "trace-export-queue", 1024))).start()
        return Tracer(
            enabled=bool(self.config.get("trace-enabled", False)),
            sample_rate=float(self.config.get("trace-sample-rate", 1.0)),
            max_traces=int(self.config.get("trace-max-traces", 256)),
            node=self.node_id,
            slow_ms=float(slow_ms or 0.0),
            exporter=exporter)

    def _make_profiler(self):
        from filodb_tpu_torch.obs.profiler import SamplingProfiler
        if not self.config.get("profiler-enabled", False):
            return None
        return SamplingProfiler(
            hz=float(self.config.get("profiler-hz", 29.0)),
            max_stacks=int(self.config.get("profiler-max-stacks", 4096)),
            top_n=int(self.config.get("profiler-top-n", 20))).start()

    def _make_shard(self, shard: int):
        """One shard: its cardinality tracker with the quota overrides,
        then the memstore shard. Shared by start-up and adoption, so an
        adopted shard cannot diverge from a primary one."""
        tracker = CardinalityTracker(
            tuple(self.config.get("card-default-quotas", ())))
        for pfx, quota in dict(
                self.config.get("card-quotas") or {}).items():
            tracker.set_quota([p for p in pfx.split(",") if p],
                              int(quota))
        # the shard registries are mutated from adopt/release/handback
        # threads too: every mutation rides _reassign_lock
        with self._reassign_lock:
            self.card_trackers[shard] = tracker
        # flush-time downsample emission into the column store's
        # <dataset>_ds_<res> datasets (ShardDownsampler.scala:40)
        fds = None
        if self.config.get("flush-downsample") \
                and self.store.column_store is not None:
            from filodb_tpu_torch.downsample.flush import FlushDownsampler
            fds = FlushDownsampler(
                self.store.column_store, self.config["dataset"], shard,
                DEFAULT_SCHEMAS,
                resolutions=tuple(self.config["downsample-resolutions"]))
        # with a column store the shard bootstraps its part keys (as ODP
        # shells) and its checkpoints from it
        return self.store.setup(
            self.ref, shard,
            num_groups=self.config["groups-per-shard"],
            max_chunk_rows=self.config["max-chunks-size"],
            bootstrap=self.store.column_store is not None,
            card_tracker=tracker,
            flush_downsampler=fds)

    def _stream(self, shard: int) -> LogIngestionStream:
        """The durable stream log of one shard (shared by every node of
        the cluster through the shared stream-dir)."""
        return LogIngestionStream(
            os.path.join(self.config["stream-dir"], f"shard={shard}",
                         "stream.log"),
            DEFAULT_SCHEMAS,
            group_commit_s=float(
                self.config["stream-group-commit-ms"]) / 1000)

    def _make_driver(self, shard: int, stream) -> IngestionDriver:
        """One ingestion driver, unstarted: the shard's single writer,
        built the same way at start-up, on adoption and on a handoff
        rollback (reference server :1073)."""
        return IngestionDriver(
            self.store.get_shard(self.ref, shard), stream,
            mapper=self.mapper,
            flush_every_records=self.config["flush-every-records"],
            flush_interval_s=float(self.config["flush-interval-s"]),
            max_resident_samples=int(self.config["max-resident-samples"]),
            ingest_batch_records=int(self.config["ingest-batch-records"]),
            max_decode_cache_bytes=int(float(
                self.config["decode-cache-mb"]) * (1 << 20)),
            max_quarantined_records=int(self.config[
                "integrity-max-quarantined-records"]))

    def _start_ingestion(self) -> None:
        """Streaming path: a durable stream log and an ingestion driver
        (recovery -> active) for each shard this node serves, then the
        influx gateway bound to the HTTP edge (NewFiloServerMain.start:
        memstore, ingestion, http)."""
        for shard in self.owned_shards:
            if shard in self.deferred_shards:
                continue        # a peer still serves it (single writer)
            with self._reassign_lock:
                self.streams[shard] = self._stream(shard)
        for shard in sorted(self.streams):
            drv = self._make_driver(shard, self.streams[shard])
            with self._reassign_lock:
                self.drivers[shard] = drv
            drv.start()
        if self.config.get("gateway-port") is not None:
            # the gateway is the producer edge: in a cluster it publishes
            # to EVERY shard's stream, not only this node's. One gateway
            # per stream set: frames are appended whole, but two
            # gateways on one log would interleave.
            gw_streams = dict(self.streams)
            if int(self.config.get("num-nodes", 1)) > 1:
                for shard in range(self.config["num-shards"]):
                    if shard not in gw_streams:
                        gw_streams[shard] = self._stream(shard)
            self._gw_streams = gw_streams
            self.gateway = GatewayServer(
                gw_streams, DEFAULT_SCHEMAS,
                num_shards=self.config["num-shards"],
                spread=int(self.config.get("default-spread", 1)),
                spread_provider=self.spread_provider,
                port=int(self.config["gateway-port"])).start()
            # the HTTP /api/v1/ingest/influx route publishes through the
            # same builders and streams as the TCP gateway
            self.http.gateway = self.gateway

    def _resolve_cluster(self) -> int:
        """Seed discovery (when no explicit peers are configured), then
        this node's id and ordinal shards. Returns the node count."""
        n = self.config["num-shards"]
        num_nodes = int(self.config.get("num-nodes", 1))
        ordinal = int(self.config.get("node-ordinal", 0))
        disc = self.config.get("discovery")
        if disc and not self.config.get("peers"):
            from filodb_tpu_torch.parallel.discovery import discover_peers
            all_nodes = discover_peers(disc)
            adv = self.config.get("advertise-url")
            if adv is None:
                raise ValueError(
                    "discovery needs advertise-url to identify this "
                    "node among the discovered seeds")
            me = [nid for nid, url in all_nodes.items()
                  if url.rstrip("/") == adv.rstrip("/")]
            if len(me) != 1:
                raise ValueError(
                    f"advertise-url {adv!r} matched {len(me)} "
                    f"discovered seeds {sorted(all_nodes.values())}")
            ordinal = int(me[0].removeprefix("node"))
            num_nodes = len(all_nodes)
            self.config["num-nodes"] = num_nodes
            self.config["node-ordinal"] = ordinal
            self.config["peers"] = {nid: url for nid, url
                                    in all_nodes.items() if nid != me[0]}
        if num_nodes > 1:
            self.node_id = f"node{ordinal}"
            self.owned_shards = shards_for_ordinal(ordinal, num_nodes, n)
        else:
            self.node_id = self.config["node-id"]
            self.owned_shards = list(range(n))
        return num_nodes

    def _make_resilience(self) -> PeerResilience:
        """The server-lifetime retry policy and per-peer breakers."""
        return PeerResilience(
            retry=RetryPolicy(
                max_attempts=int(self.config["peer-retry-attempts"]),
                base_delay_s=float(self.config["peer-retry-base-delay-s"])),
            breakers=BreakerRegistry(
                failure_threshold=int(
                    self.config["breaker-failure-threshold"]),
                reset_timeout_s=float(self.config["breaker-reset-s"])))

    def start(self) -> "FiloServer":
        """Build the backend, the shards this node serves (bootstrapped
        from the column store when there is one) and the HTTP edge; start
        the gRPC query service, the failure detector and membership in a
        cluster, the ingestion drivers and the gateway when stream-dir is
        set, and start serving. Raises when the backend's device is
        missing, or when the gRPC plane is asked for without grpcio."""
        if self.config.get("grpc-port") is not None:
            # a gRPC plane that is asked for is never dropped quietly: a
            # node without grpcio fails before it builds or binds anything
            from filodb_tpu_torch.grpcsvc.client import import_grpc
            import_grpc()
        swi = self.config.get("gil-switch-interval-ms")
        if swi:
            # request threads do short bursts of socket I/O between
            # compute: a shorter switch interval keeps them interleaving
            sys.setswitchinterval(float(swi) / 1000.0)
        if self.backend is None:
            # built first: a node without its device fails before it
            # binds a port
            from filodb_tpu_torch.query.backend import TorchBackend
            from filodb_tpu_torch.query.tilestore import resolve_device
            device = resolve_device(self.config.get("device"))
            self.backend = TorchBackend(
                device=device,
                batcher=MicroBatcher(
                    gather_window_s=float(self.config.get(
                        "batch-gather-window-ms", 1.0)) / 1000.0,
                    max_batch=int(self.config.get("batch-max", 8)),
                    enabled=bool(self.config.get("batch-enabled", True)),
                    device=device))
        n = self.config["num-shards"]
        num_nodes = self._resolve_cluster()
        self.spread_provider = SpreadProvider(
            int(self.config.get("default-spread", 1)),
            dict(self.config.get("spread-overrides") or {}))
        # rejoin deferral (parallel/membership.py): before creating a
        # shard this node owns by ordinal, ask the peers whether one of
        # them still SERVES it (it adopted the shard while this node was
        # down). Deferred shards are neither created nor ingested here;
        # the temporary owner hands them back make-before-break through
        # /admin/adopt.
        peer_claims: Dict[int, tuple] = {}
        if num_nodes > 1 and self.config.get("elastic-membership", True):
            probe_peers = {k: v for k, v in
                           dict(self.config.get("peers") or {}).items()
                           if k != self.node_id}
            if probe_peers:
                from filodb_tpu_torch.parallel.membership import \
                    probe_peer_claims
                peer_claims = probe_peer_claims(probe_peers,
                                                self.owned_shards)
        self.deferred_shards = set(peer_claims)
        for shard in self.owned_shards:
            if shard not in self.deferred_shards:
                self._make_shard(shard)
        if num_nodes > 1:
            for i in range(num_nodes):
                owned_i = shards_for_ordinal(i, num_nodes, n)
                self._original_shards[f"node{i}"] = list(owned_i)
                for shard in owned_i:
                    self.mapper.assign(shard, f"node{i}")
        else:
            assign_shards_evenly(self.mapper, [self.node_id])
        streaming = bool(self.config.get("stream-dir"))
        # peer shards start ACTIVE optimistically; the failure detector
        # flips them DOWN when health checks fail. Own shards activate
        # here only without streaming (the ingestion drivers take them
        # through RECOVERY -> ACTIVE otherwise).
        owned = set(self.owned_shards) - self.deferred_shards
        for shard in range(n) if num_nodes > 1 else self.owned_shards:
            if shard in self.deferred_shards:
                continue
            if shard in owned and streaming:
                continue
            self.mapper.activate(shard)
        # deferred shards are owned by their claimer until handed back
        for shard, (claimer, st) in sorted(peer_claims.items()):
            self.mapper.assign(shard, claimer)
            try:
                self.mapper.update(shard, ShardStatus(st), claimer)
            except ValueError:
                self.mapper.update(shard, ShardStatus.ACTIVE, claimer)
        # raw/downsample tiering: queries reaching before now - retention
        # read the ds datasets of the column store
        ds_stores: Dict[str, object] = {}
        retention_ms = 0
        if (self.config.get("raw-retention-s")
                and self.store.column_store is not None):
            from filodb_tpu_torch.downsample import DownsampledTimeSeriesStore
            retention_ms = int(self.config["raw-retention-s"]) * 1000
            ds_stores[self.ref.dataset] = DownsampledTimeSeriesStore(
                self.store.column_store, self.ref.dataset, n,
                resolutions=tuple(self.config["downsample-resolutions"]))
        peers = {k: v for k, v in
                 dict(self.config.get("peers") or {}).items()
                 if k != self.node_id}
        self.http = FiloHttpServer(
            {self.ref.dataset: self.store.shards(self.ref)},
            backend=self.backend, shard_mapper=self.mapper,
            spread=int(self.config.get("default-spread", 1)),
            port=self.config["port"],
            ds_store_by_dataset=ds_stores,
            raw_retention_ms=retention_ms,
            query_limits=QueryLimits(
                series_limit=int(self.config.get("query-series-limit", 0)),
                sample_limit=int(self.config.get("query-sample-limit", 0))),
            spread_provider=self.spread_provider,
            node_id=self.node_id, peers=peers,
            buddies=dict(self.config.get("buddy-peers") or {}),
            partitions=dict(self.config.get("partitions") or {}),
            local_partitions=list(
                self.config.get("local-partitions") or ()),
            grpc_peers={k: v for k, v in dict(
                self.config.get("grpc-peers") or {}).items()
                if k != self.node_id},
            grpc_partitions=dict(
                self.config.get("grpc-partitions") or {}),
            query_timeout_s=float(self.config["query-timeout-s"]),
            resilience=self._make_resilience(),
            plan_cache_size=int(self.config.get("plan-cache-size", 256)),
            results_cache_mb=float(
                self.config.get("results-cache-mb", 64)),
            results_cache_hot_window_ms=float(
                self.config.get("results-cache-hot-window-ms", 10_000)),
            max_inflight_queries=int(self.config.get(
                "max-inflight-queries", 4)),
            admission_wait_s=float(self.config.get(
                "admission-wait-s", 5.0)),
            qos_budgets=self._make_qos_budgets(),
            qos_degrade_max_steps=int(self.config.get(
                "qos-degrade-max-steps", 64)),
            qos_shed_degraded=bool(self.config.get(
                "qos-shed-degraded", True)),
            tracer=self._make_tracer(),
            slow_query_ms=float(self.config.get("slow-query-ms",
                                                1000.0)),
            peer_fanout_workers=int(self.config.get(
                "peer-fanout-workers", 0) or 0),
            worker_id=self.config.get("worker-id"),
            profiler=self._make_profiler())
        # the shared public accept edge: bound here with SO_REUSEPORT (the
        # kernel balances connections across the workers) or inherited
        # from the supervisor; both feed the private port's handlers
        accept_sock = None
        if self.config.get("accept-fd") is not None:
            accept_sock = socket.socket(fileno=int(self.config["accept-fd"]))
        elif self.config.get("accept-port"):
            accept_sock = bind_reuseport(
                str(self.config["accept-host"]),
                int(self.config["accept-port"]))
            if accept_sock is None:
                raise RuntimeError(
                    "accept-port needs SO_REUSEPORT, which this platform "
                    "lacks: the supervisor passes a listening fd instead "
                    "(accept-fd)")
        if accept_sock is not None:
            self.accept_port = accept_sock.getsockname()[1]
            self.http.add_listener(accept_sock)
        # elastic membership: wire the planned-handoff coordinator BEFORE
        # the HTTP edge starts serving, so an adopt/hand-back request
        # arriving the instant the health endpoint answers finds it ready
        from filodb_tpu_torch.parallel.membership import MembershipManager
        self.membership = MembershipManager(
            self, handoff_timeout_s=float(self.config["handoff-timeout-s"]))
        self.http.membership = self.membership
        if self.config.get("grpc-port") is not None:
            from filodb_tpu_torch.grpcsvc import GrpcQueryServer
            self.grpc_server = GrpcQueryServer(
                self.http, port=int(self.config["grpc-port"]))
            self.http.grpc_server = self.grpc_server
        self.http.start()
        if self.grpc_server is not None:
            self.grpc_server.start()
        if peers:
            from filodb_tpu_torch.parallel.cluster import FailureDetector
            shards_by_node = {node: self.mapper.shards_for_node(node)
                              for node in peers}
            grace = self.config.get("shard-reassign-grace-s")
            self.detector = FailureDetector(
                self.mapper, peers, shards_by_node,
                interval_s=float(self.config["failure-detect-interval-s"]),
                threshold=int(self.config["failure-detect-threshold"]),
                reassign_grace_s=(float(grace) if grace is not None
                                  else None),
                on_node_down=self._on_node_down,
                on_node_up=self._on_node_up,
                grpc_peer_sink=self.http.grpc_peers,
                peer_state_sink=self.http.peer_watermarks).start()
            # the health body advertises this node's down-view (quorum
            # input) and served-shard statuses (gossip) to its peers
            self.http.detector = self.detector
        if self.config.get("bus-port"):
            self._start_bus()
        meter_s = float(self.config.get("tenant-metering-interval-s", 0))
        if meter_s > 0 and self.card_trackers:
            self.tenant_metering = TenantMetering(
                self.card_trackers, interval_s=meter_s).start()
            self.http.tenant_metering = self.tenant_metering
        # host-level series on every exposition build
        register_process_collector()
        if streaming:
            self._start_ingestion()
        if self.config.get("self-monitor"):
            self._start_selfmon()
        if self.config.get("rules") or self.config.get("rules-file"):
            self._start_rules()
        if self.config.get("gc-freeze", True):
            # move the large, permanent start-up object graph (torch and
            # CUDA state included) out of the collector's reach and make
            # full collections 10x rarer
            gc.collect()
            gc.freeze()
            t0, t1, t2 = gc.get_threshold()
            gc.set_threshold(t0, t1, max(t2, 100))
        return self

    # -- control plane (standalone/bus.py) --------------------------------
    def _start_bus(self) -> None:
        """Connect to the supervisor's bus: local mapper transitions go to
        the siblings the instant they commit, the siblings' are applied to
        the local mapper (whose subscribers invalidate the caches), schema
        invalidations arrive host-wide, and watermark/backfill gossip beats
        faster than the health-body path."""
        from filodb_tpu_torch.standalone.bus import BusClient, wait_connected
        bc = BusClient(int(self.config["bus-port"]),
                       int(self.config.get("worker-id") or 0), self.node_id)
        bc.on("topology", self._bus_apply_topology)
        bc.on("schema", self._bus_apply_schema)
        bc.on("watermarks", self._bus_apply_watermarks)
        bc.on("worker-exit", self._bus_apply_worker_exit)
        bc.on("worker-up", self._bus_apply_worker_up)
        self.bus_client = bc.start()
        # connected before the startup line goes out: the supervisor's
        # worker-up for this worker, which announces it to the rule
        # election, follows that line and is not replayed
        wait_connected(bc)
        self.http.bus_client = bc
        self.mapper.subscribe(self._bus_publish_topology)
        tick_s = float(self.config["bus-watermark-interval-s"])
        if tick_s > 0:
            self._bus_tick_thread = threading.Thread(
                target=self._bus_watermark_run, args=(tick_s,),
                daemon=True, name="bus-watermark-tick")
            self._bus_tick_thread.start()

    def _bus_publish_topology(self, ev) -> None:
        """ShardMapper subscriber: ship every locally witnessed transition
        to the siblings. ``BusClient.publish`` does nothing on the bus
        reader thread (the apply-republish loop breaker) and on a transport
        failure (the detector's gossip converges)."""
        bc = self.bus_client
        if bc is None:
            return
        bc.publish({"type": "topology", "shard": int(ev.shard),
                    "status": ev.status.value, "node": ev.node,
                    "epoch": self.mapper.topology_epoch})

    def _bus_apply_topology(self, ev: Dict) -> None:
        """A sibling witnessed a shard transition: converge the local
        mapper, which fires this worker's own subscribers and so the
        plan/results-cache invalidation. An event already converged is
        dropped without touching the caches, and so is one that names
        THIS node: it is the ground truth for its own shards. A sibling's
        failure detector that flips them DOWN while this worker is slow
        to answer (start-up, a long host-bound query) would otherwise mark
        them DOWN here too, advertise that in the health body, and keep
        them DOWN everywhere once the detector sees the worker back
        (ROADMAP C.21; the reference applies it)."""
        try:
            shard = int(ev.get("shard", -1))
            st = ShardStatus(str(ev.get("status")))
        except (TypeError, ValueError):
            return
        if not 0 <= shard < self.mapper.num_shards:
            return
        node = ev.get("node")
        if node == self.node_id:
            return
        if self.mapper.status(shard) is st \
                and self.mapper.node_of(shard) == node:
            return
        self.mapper.update(shard, st, node)

    def _bus_apply_schema(self, ev: Dict) -> None:
        self.http.invalidate_plan_cache(str(ev.get("reason") or "schema-bus"))

    def _bus_apply_watermarks(self, ev: Dict) -> None:
        """Sibling watermark/backfill gossip into the per-peer sink the
        failure detector fills from health bodies, so the results cache's
        freshness horizon tracks sibling ingest at bus latency."""
        origin = str(ev.get("origin") or "")
        if not origin or origin == self.node_id:
            return

        def ints(raw):
            try:
                return {int(k): int(v) for k, v in (raw or {}).items()}
            except (TypeError, ValueError):
                return {}
        self.http.peer_watermarks[origin] = {
            "watermarks": ints(ev.get("watermarks")),
            "epochs": ints(ev.get("backfill_epochs")),
            "topo_epoch": int(ev.get("topo_epoch") or 0),
        }

    @staticmethod
    def _worker_ordinal(node: str) -> Optional[int]:
        try:
            return int(node.removeprefix("node"))
        except ValueError:
            return None

    def _bus_apply_worker_exit(self, ev: Dict) -> None:
        """The supervisor reaped a sibling: the detector drops it at once,
        and if it was the rule evaluator the next-lowest alive ordinal
        takes over at its next boundary."""
        node = str(ev.get("node") or "")
        if self.detector is not None and node:
            self.detector.note_peer_exit(node)
        ordinal = self._worker_ordinal(node)
        if self.rules is not None and ordinal is not None:
            self.rules.note_worker_exit(ordinal)

    def _bus_apply_worker_up(self, ev: Dict) -> None:
        node = str(ev.get("node") or "")
        if self.detector is not None and node:
            self.detector.note_peer_up(node)
        ordinal = self._worker_ordinal(node)
        if self.rules is not None and ordinal is not None:
            self.rules.note_worker_up(ordinal)

    def _bus_gossip_once(self) -> None:
        """One watermark/backfill beat onto the bus (the per-shard fields
        the health body advertises)."""
        watermarks: Dict[str, int] = {}
        epochs: Dict[str, int] = {}
        for lst in self.http.user_shard_lists():
            for i, s in enumerate(lst):
                n = getattr(s, "shard_num", i)
                wm = getattr(s, "ingest_watermark_ms", None)
                if wm is not None:
                    watermarks[str(n)] = int(wm)
                epochs[str(n)] = int(getattr(
                    s, "ingest_backfill_epoch", 0) or 0)
        self.bus_client.publish({
            "type": "watermarks", "watermarks": watermarks,
            "backfill_epochs": epochs,
            "topo_epoch": self.mapper.topology_epoch})

    @thread_root("bus-watermark-tick")
    def _bus_watermark_run(self, interval_s: float) -> None:
        while not self._bus_tick_stop.wait(interval_s):
            try:
                self._bus_gossip_once()
            except Exception:   # noqa: BLE001 — the gossip must not die
                logging.getLogger(__name__).exception(
                    "bus watermark gossip failed")

    # -- reserved internal datasets (selfmon + rules write-back) ----------
    def _setup_internal_dataset(self, dataset: str, subdir: str):
        """One internal shard per process for a reserved dataset, numbered
        by worker ordinal (0 outside a supervisor), with its OWN
        cardinality tracker: internal series are invisible to user
        cardinality accounting and quotas. With a stream-dir the producer
        appends to a dedicated stream and a normal ingestion driver
        replays it (derived series survive restarts); memory-only
        deployments ingest directly and flush explicitly, so the
        freshness watermark still advances. Returns ``(shard, stream,
        driver)`` (stream and driver None without a stream-dir)."""
        shard_num = int(self.config.get("worker-id") or 0)
        ref = DatasetRef(dataset)
        shard = self.store.setup(
            ref, shard_num, num_groups=2,
            max_chunk_rows=self.config["max-chunks-size"],
            bootstrap=self.store.column_store is not None,
            card_tracker=CardinalityTracker())
        self.http.shards_by_dataset[dataset] = self.store.shards(ref)
        stream = driver = None
        if self.config.get("stream-dir"):
            stream = LogIngestionStream(
                os.path.join(self.config["stream-dir"], subdir,
                             f"shard={shard_num}", "stream.log"),
                DEFAULT_SCHEMAS,
                group_commit_s=float(
                    self.config["stream-group-commit-ms"]) / 1000)
            driver = IngestionDriver(
                shard, stream, mapper=None,
                flush_interval_s=float(self.config["flush-interval-s"]),
                ingest_batch_records=int(
                    self.config["ingest-batch-records"]))
            driver.start()
        return shard, stream, driver

    def _start_selfmon(self) -> None:
        """The reserved ``__selfmon__`` dataset and its loop."""
        from filodb_tpu_torch.obs.selfmon import SELFMON_DATASET, SelfMonitor
        wid = self.config.get("worker-id")
        shard, stream, driver = self._setup_internal_dataset(
            SELFMON_DATASET, "selfmon")
        self._selfmon_stream = stream
        self._selfmon_driver = driver
        self.selfmon = SelfMonitor(
            self.http.build_exposition, shard,
            schemas=DEFAULT_SCHEMAS, stream=stream,
            interval_s=float(self.config["self-monitor-interval-s"]),
            node=self.node_id,
            worker_id=int(wid) if wid is not None else None,
            flush_every_ticks=int(self.config["self-monitor-flush-ticks"]))
        self.http.selfmon = self.selfmon
        self.selfmon.start()

    def _start_rules(self) -> None:
        """Load the rule groups and start the scheduler. Evaluations run
        through ``FiloHttpServer.rule_eval_range`` (the plan cache, the
        results cache and QoS under the reserved ``__rules__`` tenant);
        recorded series and ALERTS write back through their own
        IngestWriteBack into the reserved ``__rules__`` dataset. Without
        a supervisor the process is announced from birth and evaluates
        (ordinal 0)."""
        from filodb_tpu_torch.obs.writeback import IngestWriteBack
        from filodb_tpu_torch.rules import (RULES_DATASET, RulesEngine,
                                            WebhookNotifier, load_groups,
                                            load_rules_file)
        if self.config.get("rules"):
            groups = load_groups(self.config["rules"])
        else:
            groups = load_rules_file(self.config["rules-file"])
        if not groups:
            return
        shard, stream, driver = self._setup_internal_dataset(
            RULES_DATASET, "rules")
        self._rules_stream = stream
        self._rules_driver = driver
        notifier = None
        url = self.config.get("rules-webhook-url")
        if url:
            notifier = WebhookNotifier(url).start()
        wid = self.config.get("worker-id")
        self.rules = RulesEngine(
            groups,
            evaluator=self.http.rule_eval_range,
            writeback=IngestWriteBack(shard, schemas=DEFAULT_SCHEMAS,
                                      stream=stream),
            default_dataset=self.config["dataset"],
            node=self.node_id,
            worker_id=int(wid) if wid is not None else None,
            num_workers=int(self.config.get("num-nodes", 1) or 1),
            span_steps=int(self.config["rules-eval-span-steps"]),
            notifier=notifier,
            # a supervised worker stands by until its own worker-up
            # broadcast (the hand-over in one bus beat); a process without
            # a bus is announced from birth
            announced=not self.config.get("bus-port"))
        self.http.rules = self.rules
        # topology and schema invalidations reach the engine's rule-plan
        # cache through the plan cache's listener chain
        self.http.plan_cache.add_invalidation_listener(
            self.rules.invalidate_plans)
        self.rules.start()

    # -- elastic recovery (shard reassignment on node loss) ---------------
    # ShardManager.scala:28 assignShardsToNodes / IngestionActor.scala:297
    # recovery protocol: every survivor independently computes the same
    # round-robin table; the shard's new owner bootstraps index + chunks
    # from the column store, replays the shared stream log from the
    # checkpoint watermark (RECOVERY with progress), then serves it.

    def _restart_driver(self, shard: int) -> None:
        """Handoff rollback: the successor never went ACTIVE — resume
        ingesting locally from the checkpoint watermark (the shard never
        left this node's serving set)."""
        if not self.config.get("stream-dir"):
            return
        stream = self.streams.get(shard)
        if stream is None:
            stream = self._stream(shard)
            with self._reassign_lock:
                self.streams[shard] = stream
        drv = self._make_driver(shard, stream)
        with self._reassign_lock:
            self.drivers[shard] = drv
        drv.start()

    def _on_node_down(self, node: str) -> None:
        from filodb_tpu_torch.parallel.cluster import reassign_dead_shards
        dead = sorted(self.mapper.shards_for_node(node))
        if not dead:
            return
        survivors = [self.node_id] + (self.detector.alive_peers()
                                      if self.detector else [])
        table = reassign_dead_shards(dead, survivors)
        with self._reassign_lock:
            self._adopted[node] = []
        mine = []
        for sh, owner in table.items():
            self.mapper.assign(sh, owner)
            # another survivor's adoption holds RECOVERY until its health
            # body advertises the shard (the detector's status gossip
            # promotes it), so queries meanwhile carry a partial-result
            # warning instead of silently missing the shard
            self.mapper.update(sh, ShardStatus.RECOVERY, owner)
            if owner == self.node_id:
                mine.append(sh)

        @thread_root("crash-adopt")
        def adopt_all():
            # off the detector's poll thread: the column-store bootstrap
            # can take long, and health checks must keep running
            if self.membership is not None:
                self.membership.note_crash_adoption()
            for sh in mine:
                with self._reassign_lock:
                    if node not in self._adopted:
                        return           # owner came back mid-adoption
                try:
                    self._adopt_shard(sh)
                    with self._reassign_lock:
                        if node in self._adopted:
                            self._adopted[node].append(sh)
                            continue
                    # owner recovered while we bootstrapped: hand back
                    self._release_shard(sh)
                except Exception:   # noqa: BLE001 — surfaced as ERROR
                    self._release_shard(sh)      # drop partial state
                    self.mapper.update(sh, ShardStatus.ERROR,
                                       self.node_id)
        threading.Thread(target=adopt_all, daemon=True,
                         name=f"adopt-{node}").start()

    def _on_node_up(self, node: str) -> None:
        if self.membership is not None \
                and self.config.get("elastic-membership", True):
            # planned hand-back: each adopted shard replays and flips
            # ACTIVE on its home node BEFORE this node releases it
            self.membership.handback(node)
            return
        with self._reassign_lock:
            mine = self._adopted.pop(node, [])
        # legacy hard cutover: hand every reassigned shard back to its
        # original owner at once, held RECOVERY until the owner's health
        # body advertises it
        for sh in self._original_shards.get(node, []):
            self.mapper.assign(sh, node)
            self.mapper.update(sh, ShardStatus.RECOVERY, node)

        @thread_root("crash-release")
        def release_all():
            # off the poll thread: driver stops join + flush
            for sh in mine:
                self._release_shard(sh)
        if mine:
            threading.Thread(target=release_all, daemon=True,
                             name=f"release-{node}").start()

    def _adopt_shard(self, shard: int, on_event=None,
                     register=None) -> None:
        with self._reassign_lock:
            self.deferred_shards.discard(shard)   # hand-back on rejoin
        self._make_shard(shard)
        # publish the widened local shard list to the HTTP layer BEFORE
        # claiming ownership in the mapper: a query planned in between
        # would see "owned by me" with no local shard and silently drop
        # it; published-but-unclaimed just routes to the previous owner
        # (planned handoff) or stays DOWN (crash path)
        with self._reassign_lock:
            self.http.shards_by_dataset[self.ref.dataset] = \
                self.store.shards(self.ref)
        self.mapper.update(shard, ShardStatus.RECOVERY, self.node_id)
        if self.config.get("stream-dir"):
            stream = self._stream(shard)
            with self._reassign_lock:
                self.streams[shard] = stream  # the gateway routes to it
            drv = self._make_driver(shard, stream)
            if on_event is not None:
                # planned adoption: membership clears the read redirect
                # when the replay completes (driver flips ACTIVE)
                drv.on_event = on_event
            if register is None:
                with self._reassign_lock:
                    self.drivers[shard] = drv
                drv.start()
            elif register(drv):
                # planned adoption: registration is the single-writer
                # gate — refused (atomically with the abort path) when
                # the handoff was cancelled mid-bootstrap
                drv.start()
        else:
            self.mapper.update(shard, ShardStatus.ACTIVE, self.node_id)

    def _release_shard(self, shard: int) -> None:
        # registry pops ride _reassign_lock; the blocking teardown
        # (driver stop() joins its thread, stream close() syncs the log
        # tail) runs strictly outside it
        with self._reassign_lock:
            drv = self.drivers.pop(shard, None)
            stream = self.streams.pop(shard, None)
            self.card_trackers.pop(shard, None)
        if drv is not None:
            drv.stop()
        if stream is not None and self._gw_streams.get(shard) \
                is not stream:
            # close by OBJECT identity: if the local gateway publishes
            # through this very stream, only drop the consumer reference
            try:
                stream.close()
            except OSError:
                pass
        self.store.remove_shard(self.ref, shard)
        with self._reassign_lock:
            self.http.shards_by_dataset[self.ref.dataset] = \
                self.store.shards(self.ref)
        # the backend's tiles of the released shard are keyed by its
        # snapshot and age out of the tile cache like any other
        if self.membership is not None:
            self.membership.note_release()

    def seed_dev_data(self, n_samples: int = 360, n_instances: int = 4,
                      start_ms: Optional[int] = None) -> int:
        """Dev loop seed (dev-gateway.sh + TestTimeseriesProducer), into
        the shards this node serves."""
        from filodb_tpu_torch.gateway.producer import (TestTimeseriesProducer,
                                                       ingest_builders)
        producer = TestTimeseriesProducer(
            DEFAULT_SCHEMAS, num_shards=self.config["num-shards"])
        if start_ms is None:
            start_ms = (int(time.time()) - n_samples * 10) * 1000
        owned = set(self.owned_shards) - set(self.deferred_shards)
        rows = 0
        for builders in (producer.gauges(start_ms, n_samples, n_instances),
                         producer.counters(start_ms, n_samples, n_instances),
                         producer.histograms(start_ms, n_samples)):
            rows += ingest_builders(
                self.store, self.ref,
                {sh: b for sh, b in builders.items() if sh in owned})
        self.store.flush_all(self.ref)
        return rows

    def stop(self, flush: bool = True) -> None:
        """Stop the gRPC service, the failure detector and the gateway,
        then the drivers (each flushing its shard unless ``flush`` is
        False: a crash leaves the unflushed tail in the stream logs
        only), then close the streams; then the metering loop, the HTTP
        edge, the trace exporter and, when the server built the backend,
        its device executor and its cached tiles (a backend passed in
        belongs to the caller). The rules engine and the self-monitoring
        loop stop first, each with its internal driver and stream (and
        each takes its collector out of the global metric registry, which
        would otherwise keep this server and its device tiles alive), then
        the control-plane client and its gossip thread."""
        if self.rules is not None:
            self.rules.stop()
        if self._rules_driver is not None:
            self._rules_driver.stop()
        if self._rules_stream is not None:
            try:
                self._rules_stream.close()
            except OSError:
                pass
        if self.selfmon is not None:
            self.selfmon.stop()
        if self._selfmon_driver is not None:
            self._selfmon_driver.stop()
        if self._selfmon_stream is not None:
            try:
                self._selfmon_stream.close()
            except OSError:
                pass
        self._bus_tick_stop.set()
        if self._bus_tick_thread is not None:
            self._bus_tick_thread.join(timeout=5)
        if self.bus_client is not None:
            self.bus_client.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.detector is not None:
            self.detector.stop()
        if self.gateway is not None:
            self.gateway.stop()
        for drv in list(self.drivers.values()):
            drv.stop(flush=flush)
        for stream in list(self.streams.values()):
            stream.close()
        for shard, stream in self._gw_streams.items():
            # close by OBJECT identity: an adopted shard put a different
            # stream object in self.streams for the same path
            if stream is not self.streams.get(shard):
                stream.close()
        if self.tenant_metering is not None:
            self.tenant_metering.stop()
        if self.http:
            if self.http.profiler is not None:
                self.http.profiler.stop()
            if self.http.tracer.exporter is not None:
                self.http.tracer.exporter.stop()
            self.http.stop()
        if self._own_backend and self.backend is not None:
            if self.backend.batcher is not None:
                self.backend.batcher.executor.stop()
            # the tiles of a backend no one else holds: release their
            # device memory now, not when the last reference to this
            # server goes
            self.backend.release()

    @property
    def port(self) -> int:
        return self.http.port if self.http else -1


@thread_root("main-idle")
def _main_idle() -> None:
    # the main thread parks here for the life of the process; a registered
    # root, so the sampling profiler attributes it instead of counting a
    # permanently-asleep thread as unattributed
    while True:
        time.sleep(3600)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filodb-torch-server")
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--port", type=int)
    p.add_argument("--num-shards", type=int)
    p.add_argument("--dataset")
    p.add_argument("--data-dir")
    p.add_argument("--stream-dir")
    p.add_argument("--gateway-port", type=int)
    p.add_argument("--device",
                   help="torch device of the backend (default: cuda)")
    p.add_argument("--self-monitor", action="store_true", default=None,
                   help="ingest this node's own metrics into the reserved "
                        "__selfmon__ dataset (PromQL over its own "
                        "telemetry)")
    p.add_argument("--rules-file",
                   help="Prometheus-style recording/alerting rule file "
                        "evaluated in-process (validate with python -m "
                        "filodb_tpu_torch.rules --check)")
    p.add_argument("--seed-dev-data", action="store_true",
                   help="generate dev series on startup")
    args = p.parse_args(argv)
    config: Dict = {}
    if args.config:
        with open(args.config) as f:
            config.update(json.load(f))
    for k in ("port", "num_shards", "dataset", "data_dir", "stream_dir",
              "gateway_port", "device", "self_monitor", "rules_file"):
        v = getattr(args, k)
        if v is not None:
            config[k.replace("_", "-")] = v
    server = FiloServer(config).start()
    if args.seed_dev_data or config.get("seed-dev-data"):
        rows = server.seed_dev_data(
            n_samples=int(config.get("seed-samples", 360)),
            n_instances=int(config.get("seed-instances", 4)),
            start_ms=config.get("seed-start-ms"))
        print(f"seeded {rows} dev samples", file=sys.stderr)
    # machine-readable startup line (test harness / dev scripts read this)
    gw = server.gateway.port if server.gateway is not None else None
    gp = server.grpc_server.port if server.grpc_server is not None \
        else None
    line = {"port": server.port, "gateway_port": gw, "grpc_port": gp}
    if server.accept_port is not None:
        line["accept_port"] = server.accept_port
        line["worker_id"] = server.config.get("worker-id")
    # the FIRST line on standard output: the supervisor marks a worker
    # ready at its first newline
    print(json.dumps(line), flush=True)
    print(f"filodb-torch server listening on :{server.port}",
          file=sys.stderr)
    try:
        _main_idle()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
