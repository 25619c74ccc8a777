"""Streaming ingestion: stream sources, per-shard drivers, recovery, and
the ingest-write health state (the counterpart of ``filodb_tpu.ingest``).

(Reference packages: kafka/ + coordinator IngestionActor/IngestionStream.)

The driver imports are lazy (PEP 562): ``IngestionDriver`` pulls in the
memstore, which offline tools walking durable files
(``python -m filodb_tpu_torch.fsck``) need not pay for just to reach the
stream codec.
"""

from filodb_tpu_torch.ingest.stream import (IngestionStream,
                                            LogIngestionStream,
                                            MemoryIngestionStream, SomeData,
                                            decode_container,
                                            encode_container)

__all__ = [
    "IngestionDriver", "start_ingestion", "IngestionStream",
    "LogIngestionStream", "MemoryIngestionStream", "SomeData",
    "decode_container", "encode_container",
]


def __getattr__(name):
    if name in ("IngestionDriver", "start_ingestion"):
        from filodb_tpu_torch.ingest import driver
        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
