"""FiloServer of the port: the standalone node binary (the counterpart of
``filodb_tpu.standalone.server``).

Wires config -> column store -> memstore shards (bootstrapped from it) ->
shard mapper -> TorchBackend (with its micro-batcher) -> HTTP API ->
durable streams, ingestion drivers and the influx gateway, mirroring the
v2 startup path (standalone/NewFiloServerMain.scala:21: start memstore,
ingestion, http) on one node.

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
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
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
from filodb_tpu_torch.obs.process import register_process_collector
from filodb_tpu_torch.obs.trace import TraceExporter, Tracer
from filodb_tpu_torch.parallel.shardmapper import (ShardMapper,
                                                   assign_shards_evenly)
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
}

# config keys whose modules are not ported yet -> the ROADMAP item that
# ports them; FiloServer refuses a config whose value turns the feature on
REFUSED = {
    "grpc-port": "A.1.3 gRPC",
    "mesh-enabled": "A.11 mesh and distributed",
    "mesh-tile-serving": "A.11 mesh and distributed",
    "raw-retention-s": "A.10 downsampling",
    "flush-downsample": "A.10 downsampling",
    "self-monitor": "A.1.7 self-monitoring",
    "rules": "A.1.6 rules",
    "rules-file": "A.1.6 rules",
    "peers": "A.1.4 multi-node and membership",
    "discovery": "A.1.4 multi-node and membership",
    "buddy-peers": "A.1.4 multi-node and membership",
    "partitions": "A.1.4 multi-node and membership",
    "worker-id": "A.1.5 supervisor",
    "accept-port": "A.1.5 supervisor",
    "accept-fd": "A.1.5 supervisor",
    "bus-port": "A.1.5 supervisor",
    "profiler-enabled": "A.9 device observability",
    "num-nodes": "A.1.4 multi-node and membership",
}

# keys of the JAX package's DEFAULTS that the port accepts at any value
# and that change nothing here -> why. Each only tunes a feature that is
# refused above (so it is off), or acts in the reference only there too.
INERT = {
    "query-timeout-s": "the reference checks the deadline only on its "
                       "remote and mesh paths (ROADMAP C.12)",
    "downsample-resolutions": "tunes downsampling: raw-retention-s and "
                              "flush-downsample are refused (A.10)",
    "profiler-hz": "tunes the profiler: profiler-enabled is refused "
                   "(A.9)",
    "profiler-max-stacks": "tunes the profiler: profiler-enabled is "
                           "refused (A.9)",
    "profiler-top-n": "tunes the profiler: profiler-enabled is refused "
                      "(A.9)",
    "self-monitor-interval-s": "tunes self-monitoring: self-monitor is "
                               "refused (A.1.7)",
    "self-monitor-flush-ticks": "tunes self-monitoring: self-monitor is "
                                "refused (A.1.7)",
    "rules-eval-span-steps": "tunes rule evaluation: rules and "
                             "rules-file are refused (A.1.6)",
    "rules-webhook-url": "alert notifications of rules: rules and "
                         "rules-file are refused (A.1.6)",
    "peer-retry-attempts": "retries of peer calls: one node has no peers "
                           "(peers refused, A.1.4)",
    "peer-retry-base-delay-s": "retries of peer calls: one node has no "
                               "peers (peers refused, A.1.4)",
    "breaker-failure-threshold": "per-peer circuit breakers: one node "
                                 "has no peers (A.1.4)",
    "breaker-reset-s": "per-peer circuit breakers: one node has no "
                       "peers (A.1.4)",
    "node-ordinal": "read only when num-nodes > 1 (refused, A.1.4)",
    "advertise-url": "read only with discovery (refused, A.1.4)",
    "local-partitions": "read only with partitions (refused, A.1.4)",
    "failure-detect-interval-s": "the failure detector runs only with "
                                 "peers (refused, A.1.4)",
    "failure-detect-threshold": "the failure detector runs only with "
                                "peers (refused, A.1.4)",
    "shard-reassign-grace-s": "shard adoption runs only with peers "
                              "(refused, A.1.4)",
    "elastic-membership": "planned handoff runs only with peers "
                          "(refused, A.1.4)",
    "handoff-timeout-s": "planned handoff runs only with peers "
                         "(refused, A.1.4)",
    "peer-fanout-workers": "metadata fan-out runs only with peers "
                           "(refused, A.1.4)",
    "grpc-peers": "gRPC leaf dispatch to peers: gRPC and peers are "
                  "refused (A.1.3, A.1.4)",
    "grpc-partitions": "gRPC federation: partitions is refused (A.1.4)",
    "accept-host": "read only with accept-port (refused, A.1.5)",
    "bus-watermark-interval-s": "read only with bus-port (refused, "
                                "A.1.5)",
}


# keys that are on for any value but None (0 = an ephemeral port, worker 0)
_ON_UNLESS_NONE = ("grpc-port", "worker-id", "accept-fd")


def _refused(key: str, value, config: Dict) -> bool:
    """Whether ``value`` turns on the unported feature behind ``key``, by
    the reference's own test of that key. ``grpc-port`` is the one key
    whose reference default (0) turns its feature on."""
    if key == "num-nodes":
        return int(value) > 1
    if key == "mesh-tile-serving":
        # serves only on the mesh: on when mesh-enabled is on as well
        return bool(value) and bool(config.get("mesh-enabled"))
    if key in _ON_UNLESS_NONE:
        return value is not None
    return bool(value)


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
        # one durable stream and one ingestion driver per shard (the
        # single writer of that shard) when stream-dir is set
        self.streams: Dict[int, LogIngestionStream] = {}
        self.drivers: Dict[int, IngestionDriver] = {}
        self.gateway: Optional[GatewayServer] = None
        self.tenant_metering: Optional[TenantMetering] = None

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

    def _make_shard(self, shard: int):
        """One shard: its cardinality tracker with the quota overrides,
        then the memstore shard."""
        tracker = CardinalityTracker(
            tuple(self.config.get("card-default-quotas", ())))
        for pfx, quota in dict(
                self.config.get("card-quotas") or {}).items():
            tracker.set_quota([p for p in pfx.split(",") if p],
                              int(quota))
        self.card_trackers[shard] = tracker
        # with a column store the shard bootstraps its part keys (as ODP
        # shells) and its checkpoints from it
        return self.store.setup(
            self.ref, shard,
            num_groups=self.config["groups-per-shard"],
            max_chunk_rows=self.config["max-chunks-size"],
            bootstrap=self.store.column_store is not None,
            card_tracker=tracker)

    def _start_ingestion(self) -> None:
        """Streaming path: per-shard durable stream logs and ingestion
        drivers (recovery -> active), then the influx gateway bound to
        the HTTP edge (NewFiloServerMain.start: memstore, ingestion,
        http)."""
        group_commit_s = float(self.config["stream-group-commit-ms"]) / 1000
        for shard in range(self.config["num-shards"]):
            stream = LogIngestionStream(
                os.path.join(self.config["stream-dir"], f"shard={shard}",
                             "stream.log"),
                DEFAULT_SCHEMAS, group_commit_s=group_commit_s)
            self.streams[shard] = stream
            # the shard's single writer (reference server :1073)
            self.drivers[shard] = IngestionDriver(
                self.store.get_shard(self.ref, shard), stream,
                mapper=self.mapper,
                flush_every_records=self.config["flush-every-records"],
                flush_interval_s=float(self.config["flush-interval-s"]),
                max_resident_samples=int(
                    self.config["max-resident-samples"]),
                ingest_batch_records=int(
                    self.config["ingest-batch-records"]),
                max_decode_cache_bytes=int(float(
                    self.config["decode-cache-mb"]) * (1 << 20)),
                max_quarantined_records=int(self.config[
                    "integrity-max-quarantined-records"])).start()
        if self.config.get("gateway-port") is not None:
            # one gateway per stream set: frames are appended whole, but
            # two gateways on one log would interleave
            self.gateway = GatewayServer(
                self.streams, DEFAULT_SCHEMAS,
                num_shards=self.config["num-shards"],
                spread=int(self.config.get("default-spread", 1)),
                spread_provider=self.spread_provider,
                port=int(self.config["gateway-port"])).start()
            # the HTTP /api/v1/ingest/influx route publishes through the
            # same builders and streams as the TCP gateway
            self.http.gateway = self.gateway

    def start(self) -> "FiloServer":
        """Build the backend, the shards (bootstrapped from the column
        store when there is one) and the HTTP edge, start the ingestion
        drivers and the gateway when stream-dir is set, and start
        serving. Raises when the backend's device is missing."""
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
        self.spread_provider = SpreadProvider(
            int(self.config.get("default-spread", 1)),
            dict(self.config.get("spread-overrides") or {}))
        for shard in range(self.config["num-shards"]):
            self._make_shard(shard)
        assign_shards_evenly(self.mapper, [self.node_id])
        streaming = bool(self.config.get("stream-dir"))
        if not streaming:
            # with streaming the drivers take each shard through
            # RECOVERY -> ACTIVE
            for shard in range(self.config["num-shards"]):
                self.mapper.activate(shard)
        self.http = FiloHttpServer(
            {self.ref.dataset: self.store.shards(self.ref)},
            backend=self.backend, shard_mapper=self.mapper,
            spread=int(self.config.get("default-spread", 1)),
            port=self.config["port"],
            query_limits=QueryLimits(
                series_limit=int(self.config.get("query-series-limit", 0)),
                sample_limit=int(self.config.get("query-sample-limit", 0))),
            spread_provider=self.spread_provider,
            node_id=self.node_id,
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
                                                1000.0)))
        self.http.start()
        meter_s = float(self.config.get("tenant-metering-interval-s", 0))
        if meter_s > 0:
            self.tenant_metering = TenantMetering(
                self.card_trackers, interval_s=meter_s).start()
            self.http.tenant_metering = self.tenant_metering
        # host-level series on every exposition build
        register_process_collector()
        if streaming:
            self._start_ingestion()
        if self.config.get("gc-freeze", True):
            # move the large, permanent start-up object graph (torch and
            # CUDA state included) out of the collector's reach and make
            # full collections 10x rarer
            gc.collect()
            gc.freeze()
            t0, t1, t2 = gc.get_threshold()
            gc.set_threshold(t0, t1, max(t2, 100))
        return self

    def seed_dev_data(self, n_samples: int = 360, n_instances: int = 4,
                      start_ms: Optional[int] = None) -> int:
        """Dev loop seed (dev-gateway.sh + TestTimeseriesProducer)."""
        from filodb_tpu_torch.gateway.producer import (TestTimeseriesProducer,
                                                       ingest_builders)
        producer = TestTimeseriesProducer(
            DEFAULT_SCHEMAS, num_shards=self.config["num-shards"])
        if start_ms is None:
            start_ms = (int(time.time()) - n_samples * 10) * 1000
        rows = 0
        for builders in (producer.gauges(start_ms, n_samples, n_instances),
                         producer.counters(start_ms, n_samples, n_instances),
                         producer.histograms(start_ms, n_samples)):
            rows += ingest_builders(self.store, self.ref, builders)
        self.store.flush_all(self.ref)
        return rows

    def stop(self, flush: bool = True) -> None:
        """Stop the gateway, then the drivers (each flushing its shard
        unless ``flush`` is False: a crash leaves the unflushed tail in
        the stream logs only), then close the streams; then the metering
        loop, the HTTP edge, the trace exporter and, when the server
        built the backend, its device executor (a backend passed in
        belongs to the caller)."""
        if self.gateway is not None:
            self.gateway.stop()
        for drv in self.drivers.values():
            drv.stop(flush=flush)
        for stream in self.streams.values():
            stream.close()
        if self.tenant_metering is not None:
            self.tenant_metering.stop()
        if self.http:
            if self.http.tracer.exporter is not None:
                self.http.tracer.exporter.stop()
            self.http.stop()
        if self._own_backend and self.backend is not None \
                and self.backend.batcher is not None:
            self.backend.batcher.executor.stop()

    @property
    def port(self) -> int:
        return self.http.port if self.http else -1


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
    p.add_argument("--seed-dev-data", action="store_true",
                   help="generate dev series on startup")
    args = p.parse_args(argv)
    config: Dict = {}
    if args.config:
        with open(args.config) as f:
            config.update(json.load(f))
    for k in ("port", "num_shards", "dataset", "data_dir", "stream_dir",
              "gateway_port", "device"):
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
    print(json.dumps({"port": server.port, "gateway_port": gw,
                      "grpc_port": None}), flush=True)
    print(f"filodb-torch server listening on :{server.port}",
          file=sys.stderr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
