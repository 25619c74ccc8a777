"""Persistence layer: pluggable ColumnStore (ChunkSink + RawChunkSource +
MetaStore checkpoint table) with a flat-file implementation.

(Reference: store/ChunkSink.scala, store/ChunkSource.scala:25 RawChunkSource,
cassandra/columnstore/CassandraColumnStore.scala:54,
cassandra/metastore/CheckpointTable.scala:26.)"""

from filodb_tpu_torch.store.columnstore import (ColumnStore,
                                                FlatFileColumnStore,
                                                NullColumnStore,
                                                PartKeyEntry)

__all__ = ["ColumnStore", "FlatFileColumnStore", "NullColumnStore",
           "PartKeyEntry"]
