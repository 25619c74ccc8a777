"""FiloServer of the port: the standalone node binary (the counterpart of
``filodb_tpu.standalone.server``).

Wires config -> memstore shards -> shard mapper -> TorchBackend (with its
micro-batcher) -> HTTP API, mirroring the v2 startup path
(standalone/NewFiloServerMain.scala:21: start memstore, http).

The backend runs on the CUDA device unless the config's ``device`` names
another one (``"cpu"`` for tests); without a card :meth:`FiloServer.start`
raises. The server never falls back to the numpy oracle.

Config keys follow the JAX package's ``DEFAULTS``. Keys whose modules the
port does not have yet raise ``ValueError`` in ``__init__`` (see
``REFUSED``), so that no setting is silently ignored.

    python -m filodb_tpu_torch.standalone.server --seed-dev-data [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

from filodb_tpu_torch.core.cardinality import CardinalityTracker
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.core.spread import SpreadProvider
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.obs.trace import TraceExporter, Tracer
from filodb_tpu_torch.parallel.shardmapper import (ShardMapper,
                                                   assign_shards_evenly)
from filodb_tpu_torch.query.batcher import MicroBatcher
from filodb_tpu_torch.query.model import QueryLimits
from filodb_tpu_torch.query.qos import TenantBudgets

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
    "num-nodes": 1,
    # gRPC query service port: None until gRPC is ported (ROADMAP A.1)
    "grpc-port": None,
}

# config keys whose modules are not ported yet -> the ROADMAP item that
# ports them; FiloServer refuses a config that sets one
REFUSED = {
    "data-dir": "A.1.2 durability",
    "stream-dir": "A.1.1 ingest edge",
    "gateway-port": "A.1.1 ingest edge",
    "grpc-port": "A.1.3 gRPC",
    "mesh-enabled": "A.11 mesh and distributed",
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
    "bus-port": "A.1.5 supervisor",
    "profiler-enabled": "A.9 device observability",
    "num-nodes": "A.1.4 multi-node and membership",
}


# keys that are on for any value but None (0 = an ephemeral port, worker 0)
_ON_UNLESS_NONE = ("gateway-port", "grpc-port", "worker-id")


def _refused(key: str, value) -> bool:
    """Whether ``value`` turns on the unported feature behind ``key``, by
    the reference's own test of that key."""
    if key == "num-nodes":
        return int(value) > 1
    if key in _ON_UNLESS_NONE:
        return value is not None
    return bool(value)


class FiloServer:
    def __init__(self, config: Optional[Dict] = None,
                 backend: Optional[object] = None):
        config = dict(config or {})
        for key, value in config.items():
            if key in REFUSED and _refused(key, value):
                raise ValueError(
                    f"config key {key!r} is not ported yet "
                    f"(ROADMAP {REFUSED[key]})")
        self.config = {**DEFAULTS, **config}
        self.ref = DatasetRef(self.config["dataset"])
        self.store = TimeSeriesMemStore(DEFAULT_SCHEMAS)
        self.mapper = ShardMapper(self.config["num-shards"])
        self.backend = backend
        # the server stops the device executor of a backend it built
        self._own_backend = backend is None
        self.http: Optional[FiloHttpServer] = None
        self.node_id: str = self.config["node-id"]

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
        return self.store.setup(
            self.ref, shard,
            num_groups=self.config["groups-per-shard"],
            max_chunk_rows=self.config["max-chunks-size"],
            card_tracker=tracker)

    def start(self) -> "FiloServer":
        """Build the shards, the backend and the HTTP edge, and start
        serving. Raises when the backend's device is missing."""
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

    def stop(self) -> None:
        """Stop the HTTP edge, the trace exporter and, when the server
        built the backend, its device executor (a backend passed in
        belongs to the caller)."""
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
    p.add_argument("--device",
                   help="torch device of the backend (default: cuda)")
    p.add_argument("--seed-dev-data", action="store_true",
                   help="generate dev series on startup")
    args = p.parse_args(argv)
    config: Dict = {}
    if args.config:
        with open(args.config) as f:
            config.update(json.load(f))
    for k in ("port", "num_shards", "dataset", "device"):
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
    print(json.dumps({"port": server.port, "gateway_port": None,
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
