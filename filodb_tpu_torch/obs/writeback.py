"""The shared write-back rail: derived series re-enter the node through
the NORMAL ingest path (the counterpart of
``filodb_tpu.obs.writeback``).

Two standing background loops produce derived series today — the
self-monitoring loop (obs/selfmon.py: the full metrics surface every
tick) and the recording-rules engine (rules/engine.py: rule outputs +
synthetic ``ALERTS`` state series). Both need exactly the same plumbing:
build :class:`~filodb_tpu_torch.core.record.RecordBuilder` containers from
``(schema, labels, timestamp, value)`` samples and push them through the
normal ingest path — durable WAL append + ingestion-driver replay when a
stream is wired (derived series survive restarts), direct shard ingest +
explicit flush otherwise (so the ingest watermark, the results cache's
freshness input, still advances).

Factored here so the rail exists ONCE: one RecordBuilder per writer
root, single-writer by construction (each standing loop owns its own
instance), identical durability semantics for every producer.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from filodb_tpu_torch.core.record import RecordBuilder

# sample-name suffixes that are cumulative (monotone) series: they
# ingest under the counter schema so rate()/increase() get counter
# semantics (reset correction) — everything else is a gauge snapshot
COUNTER_SUFFIXES = ("_total", "_bucket", "_count", "_sum")


def schema_for_sample(family_type: str, sample_name: str) -> str:
    """Ingest schema for one derived sample: counters (and histogram
    children / counter-suffixed names) take the counter schema so
    ``rate()`` gets reset correction; everything else is a gauge."""
    if family_type == "counter":
        return "prom-counter"
    if family_type == "histogram" or sample_name.endswith(
            COUNTER_SUFFIXES):
        return "prom-counter"
    return "gauge"


class IngestWriteBack:
    """One producer's write-back rail into an internal dataset shard.

    ``write()`` builds containers from samples and hands them to the
    durable stream when one is wired (the ingestion driver replays them
    into the memstore — the full WAL path, recovery included) or
    straight to ``shard.ingest`` otherwise. ``flush()`` advances the
    direct-ingest shard's watermark; it is a no-op in durable mode
    (the driver owns the flush cadence there)."""

    def __init__(self, shard, schemas=None, stream=None):
        from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
        self.shard = shard
        self.schemas = schemas or DEFAULT_SCHEMAS
        self.stream = stream
        self.samples_written = 0

    @property
    def durable(self) -> bool:
        return self.stream is not None

    def write(self, samples: Iterable[Tuple[str, dict, int, float]]
              ) -> int:
        """Ingest ``(schema_name, labels, timestamp_ms, value)`` samples
        through the normal path; returns the number written."""
        rb = RecordBuilder(self.schemas)
        n = 0
        for schema_name, labels, ts_ms, value in samples:
            rb.add_sample(schema_name, labels, int(ts_ms), float(value))
            n += 1
        for cont in rb.containers():
            if self.stream is not None:
                # durable WAL first; the ingestion driver replays it
                # into the memstore (recovery-safe, group-commit fsync)
                self.stream.append(cont)
            else:
                self.shard.ingest(cont)
        self.samples_written += n
        return n

    def flush(self) -> None:
        """Direct-ingest mode: flush so the ingest watermark (the
        results cache's freshness input) advances like any shard. In
        durable mode the driver flushes on its own cadence."""
        if self.stream is None:
            self.shard.flush_all()
