"""Synthetic time-series producers (gateway TestTimeseriesProducer
equivalent, gateway/src/main/scala/filodb/timeseries/
TestTimeseriesProducer.scala) — deterministic dev/test data shaped like the
reference's: `heap_usage` gauges, `http_requests_total` counters and
`http_request_latency` histograms across n instances, sharded exactly the
way the reference shards (shard-key hash + spread via ShardMapper)."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.record import (PartKey, RecordBuilder, ingestion_shard,
                                    shard_key_hash)
from filodb_tpu_torch.core.schemas import Schemas
from filodb_tpu_torch.memory.histogram import CustomBuckets


class TestTimeseriesProducer:
    """Generates samples into per-shard RecordBuilders."""

    __test__ = False          # named after the reference class, not a test

    def __init__(self, schemas: Schemas, num_shards: int = 4,
                 spread: int = 1, ws: str = "demo", ns: str = "App-0"):
        self.schemas = schemas
        self.num_shards = num_shards
        self.spread = spread
        self.ws, self.ns = ws, ns

    def _labels(self, metric: str, instance: int) -> Dict[str, str]:
        return {"_metric_": metric, "_ws_": self.ws, "_ns_": self.ns,
                "job": "test", "instance": f"instance-{instance}",
                "host": f"h{instance % 4}"}

    def shard_for(self, schema_name: str, labels: Dict[str, str]) -> int:
        from filodb_tpu_torch.core.schemas import PartitionSchema
        schema = self.schemas.by_name(schema_name)
        pk = PartKey.make(schema, labels)
        skh = pk.shard_key_hash(PartitionSchema())
        return ingestion_shard(skh, pk.part_hash(), self.spread,
                               self.num_shards)

    def gauges(self, start_ms: int, n_samples: int, n_instances: int = 4,
               step_ms: int = 10_000, metric: str = "heap_usage"
               ) -> Dict[int, RecordBuilder]:
        """Sinusoid-ish gauges (TestTimeseriesProducer gauge shape)."""
        builders: Dict[int, RecordBuilder] = {}
        for inst in range(n_instances):
            labels = self._labels(metric, inst)
            shard = self.shard_for("gauge", labels)
            b = builders.setdefault(shard, RecordBuilder(self.schemas))
            for i in range(n_samples):
                val = 15.0 + 8.0 * math.sin((i + inst) / 10.0) \
                    + (i % 5) * 0.1
                b.add_sample("gauge", labels, start_ms + i * step_ms, val)
        return builders

    def counters(self, start_ms: int, n_samples: int, n_instances: int = 4,
                 step_ms: int = 10_000,
                 metric: str = "http_requests_total"
                 ) -> Dict[int, RecordBuilder]:
        builders: Dict[int, RecordBuilder] = {}
        for inst in range(n_instances):
            labels = self._labels(metric, inst)
            shard = self.shard_for("prom-counter", labels)
            b = builders.setdefault(shard, RecordBuilder(self.schemas))
            v = 0.0
            for i in range(n_samples):
                v += (inst + 1) * 10.0
                b.add_sample("prom-counter", labels,
                             start_ms + i * step_ms, v)
        return builders

    def histograms(self, start_ms: int, n_samples: int, n_instances: int = 2,
                   step_ms: int = 10_000,
                   metric: str = "http_request_latency",
                   les: Iterable[float] = (2, 4, 8, 16, 32, 64, float("inf"))
                   ) -> Dict[int, RecordBuilder]:
        """Prom-histogram samples (sum, count, hist) with fixed buckets."""
        les_arr = np.asarray(list(les), dtype=np.float64)
        buckets = CustomBuckets(les_arr)
        builders: Dict[int, RecordBuilder] = {}
        rng = np.random.default_rng(42)
        for inst in range(n_instances):
            labels = self._labels(metric, inst)
            shard = self.shard_for("prom-histogram", labels)
            b = builders.setdefault(shard, RecordBuilder(self.schemas))
            cum = np.zeros(les_arr.size)
            total, count = 0.0, 0
            for i in range(n_samples):
                lat = rng.exponential(8.0)
                cum += (les_arr >= lat)
                total += lat
                count += 1
                b.add_sample("prom-histogram", labels,
                             start_ms + i * step_ms,
                             total, float(count), (buckets, cum.copy()))
        return builders


def ingest_builders(store, ref, builders: Dict[int, RecordBuilder]) -> int:
    """Push per-shard builders into a TimeSeriesMemStore; returns rows."""
    n = 0
    for shard, b in builders.items():
        for c in b.containers():
            store.ingest(ref, shard, c)
            n += len(c)
    return n
