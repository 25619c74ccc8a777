"""Gateway TCP server: influx line protocol in, per-shard streams out.

(Reference: gateway/src/main/scala/filodb/gateway/GatewayServer.scala —
Netty TCP server :60 parsing influx lines, computing shardKeyHash/
partKeyHash and routing via shardMapper.ingestionShard :120,164, batching
per-shard RecordBuilders, publishing containers to Kafka via
KafkaContainerSink.  Here "Kafka" is the per-shard LogIngestionStream and
the server is a stdlib ThreadingTCPServer — the ingest edge is host-side
I/O, not device work.)

Wire protocol: newline-delimited influx lines; `#`-prefixed lines are
comments.  Batches are published per shard every ``batch_lines`` lines or
when a connection closes, preserving per-connection ordering per shard.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Dict, List, Optional

from filodb_tpu_torch.core.record import RecordBuilder, ingestion_shard
from filodb_tpu_torch.ingest import health as ingest_health
from filodb_tpu_torch.core.record import PartKey
from filodb_tpu_torch.core.schemas import PartitionSchema, Schemas
from filodb_tpu_torch.gateway.influx import input_records, parse_line
from filodb_tpu_torch.ingest.stream import IngestionStream
from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root


@guarded_by("_stats_lock", "lines_ingested", "lines_rejected",
            "batches_dropped")
class GatewayServer:
    """TCP ingest edge, one instance per gateway process.

    Line/drop counters ride ``_stats_lock``: producer threads (one per
    TCP connection) and the HTTP ingest edge (``/api/v1/ingest/influx``
    handler threads) both route lines through this object."""

    def __init__(self, streams: Dict[int, IngestionStream], schemas: Schemas,
                 num_shards: int, spread: int = 1, port: int = 0,
                 host: str = "127.0.0.1", batch_lines: int = 256,
                 ws: str = "demo", ns: str = "App-0",
                 spread_provider=None):
        self.streams = streams
        self.schemas = schemas
        self.num_shards = num_shards
        self.spread = spread
        # per-shard-key overrides; the planner prunes with the SAME
        # provider so ingest and query always agree (SpreadProvider)
        self.spread_provider = spread_provider
        self.batch_lines = batch_lines
        self.ws, self.ns = ws, ns
        self.part_schema = PartitionSchema()
        self._stats_lock = threading.Lock()
        self.lines_ingested = 0
        self.lines_rejected = 0
        # batches dropped while ingest is degraded to read-only (the
        # fire-and-forget TCP edge has no backpressure channel — counted
        # loss beats a crashed producer thread; HTTP ingest gets a 503)
        self.batches_dropped = 0
        gateway = self

        class Handler(socketserver.StreamRequestHandler):
            # per-connection producer thread (ThreadingTCPServer spawn
            # the AST engine cannot see)
            @thread_root("gateway-producer")
            def handle(self):
                builders: Dict[int, RecordBuilder] = {}
                pending = 0
                for raw in self.rfile:
                    line = raw.decode("utf-8", errors="replace").strip()
                    if not line or line.startswith("#"):
                        continue
                    if gateway._route_line(line, builders):
                        pending += 1
                    if pending >= gateway.batch_lines:
                        gateway._publish(builders)
                        pending = 0
                gateway._publish(builders)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- routing -----------------------------------------------------------
    def _route_line(self, line: str, builders: Dict[int, RecordBuilder]
                    ) -> bool:
        """Parse one line, append each resulting sample to its shard's
        builder (GatewayServer.scala:120 shardKeyHash->ingestionShard)."""
        try:
            rec = parse_line(line)
            samples = input_records(rec, self.ws, self.ns)
        except ValueError:
            with self._stats_lock:
                self.lines_rejected += 1
            return False
        for schema_name, labels, ts, values in samples:
            schema = self.schemas.by_name(schema_name)
            pk = PartKey.make(schema, labels)
            if self.spread_provider is not None:
                spread = self.spread_provider.spread_for_labels(
                    labels, self.part_schema.non_metric_shard_key_columns)
            else:
                spread = self.spread
            shard = ingestion_shard(pk.shard_key_hash(self.part_schema),
                                    pk.part_hash(), spread,
                                    self.num_shards)
            b = builders.setdefault(shard, RecordBuilder(self.schemas))
            b.add_sample(schema_name, labels, ts, *values)
        with self._stats_lock:
            self.lines_ingested += 1
        return True

    def _publish(self, builders: Dict[int, RecordBuilder],
                 raise_on_error: bool = False) -> None:
        """Flush per-shard builders into their streams (KafkaContainerSink).

        Write-path out-of-space degrades instead of crashing the
        producer thread: the process flips to ingest-read-only
        (ingest/health.py), and while degraded this edge DROPS batches
        (counted) except for the rate-limited probe write that detects
        recovery. ``raise_on_error=True`` (the HTTP ingest edge) raises
        :class:`~filodb_tpu_torch.ingest.health.IngestReadOnly` instead so
        the caller can answer 503 + Retry-After."""
        health = ingest_health.GLOBAL
        if health.read_only() and not health.should_probe():
            # containers() drains the builders — the batch is lost
            # either way (dropped here, or retried wholesale by the
            # HTTP caller after its 503)
            dropped = sum(len(b.containers()) for b in builders.values())
            if dropped:
                with self._stats_lock:
                    self.batches_dropped += 1
            if raise_on_error:
                raise health.reject()
            return
        wrote = False
        for shard, b in builders.items():
            stream = self.streams.get(shard)
            if stream is None:
                continue
            for cont in b.containers():
                try:
                    stream.append(cont)
                    wrote = True
                except OSError as e:
                    if health.note_write_error(e, "gateway publish"):
                        with self._stats_lock:
                            self.batches_dropped += 1
                        if raise_on_error:
                            raise health.reject() from e
                        return
                    raise
        if wrote:
            health.note_write_ok()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GatewayServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="gateway-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def port(self) -> int:
        return self._server.server_address[1]


def send_lines(host: str, port: int, lines: List[str],
               timeout: float = 10.0) -> None:
    """Small client for tests/tools: push influx lines to a gateway."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        payload = ("\n".join(lines) + "\n").encode()
        s.sendall(payload)
