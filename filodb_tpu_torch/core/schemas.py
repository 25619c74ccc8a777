"""Schema registry: column types, data/partition schemas, built-in schemas.

Re-design of the reference's metadata layer
(core/src/main/scala/filodb.core/metadata/Schemas.scala:66,126,370,
metadata/Column.scala, metadata/Dataset.scala:73,143).  Built-in schema
definitions mirror core/src/main/resources/filodb-defaults.conf:121-275.

Each schema gets a 16-bit ``schema_id`` derived from a hash of its column
definitions (Schemas.scala embeds this in partkeys); ids are stable across
processes because the hash input is the canonical schema string.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional, Sequence, Tuple

from filodb_tpu_torch.utils.xxhash import xxhash32


class ColumnType(Enum):
    TIMESTAMP = "ts"
    LONG = "long"
    DOUBLE = "double"
    INT = "int"
    STRING = "string"
    MAP = "map"
    BINARY = "binary"
    HISTOGRAM = "hist"


@dataclass(frozen=True)
class Column:
    name: str
    col_type: ColumnType
    # column params (Column.scala / conf column defs like detectDrops=true)
    detect_drops: bool = False   # counter semantics: detect resets
    counter: bool = False        # histogram counter flag
    delta: bool = False          # delta temporality (otel delta)

    @property
    def is_counter_like(self) -> bool:
        return self.detect_drops or self.counter

    def canonical(self) -> str:
        return (f"{self.name}:{self.col_type.value}:"
                f"{int(self.detect_drops)}{int(self.counter)}{int(self.delta)}")


@dataclass(frozen=True)
class DataSchema:
    """Columns of one time series sample (DataSchema, Schemas.scala:66)."""
    name: str
    columns: Tuple[Column, ...]
    value_column: str
    downsamplers: Tuple[str, ...] = ()
    downsample_period_marker: str = "time(0)"
    downsample_schema: Optional[str] = None

    @property
    def schema_id(self) -> int:
        """16-bit schema hash embedded in partkeys (Schemas.scala:370)."""
        canon = self.name + "|" + "|".join(c.canonical() for c in self.columns)
        return xxhash32(canon.encode()) & 0xFFFF

    @property
    def timestamp_column(self) -> Column:
        return self.columns[0]

    @property
    def data_columns(self) -> Tuple[Column, ...]:
        return self.columns[1:]

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def value_column_index(self) -> int:
        for i, c in enumerate(self.columns):
            if c.name == self.value_column:
                return i
        raise KeyError(self.value_column)


@dataclass(frozen=True)
class PartitionSchema:
    """Partition-key schema: which labels form the shard key
    (PartitionSchema, Schemas.scala:126; defaults filodb-defaults.conf:95-100).
    """
    shard_key_columns: Tuple[str, ...] = ("_ws_", "_ns_", "_metric_")
    metric_column: str = "_metric_"

    @property
    def non_metric_shard_key_columns(self) -> Tuple[str, ...]:
        return tuple(c for c in self.shard_key_columns if c != self.metric_column)


def _col(spec: str) -> Column:
    """Parse "name:type[:opts]" column spec (conf format,
    filodb-defaults.conf:125)."""
    parts = spec.split(":")
    name, ctype = parts[0], ColumnType(parts[1])
    opts = {}
    if len(parts) > 2:
        raw = parts[2].strip("{}")
        for kv in raw.split(","):
            if kv:
                k, v = kv.split("=")
                opts[k.strip()] = v.strip() == "true"
    return Column(
        name, ctype,
        detect_drops=opts.get("detectDrops", False),
        counter=opts.get("counter", False),
        delta=opts.get("delta", False),
    )


def _schema(name, col_specs, value_column, downsamplers=(), marker="time(0)",
            ds_schema=None) -> DataSchema:
    return DataSchema(
        name=name,
        columns=tuple(_col(s) for s in col_specs),
        value_column=value_column,
        downsamplers=tuple(downsamplers),
        downsample_period_marker=marker,
        downsample_schema=ds_schema,
    )


# Built-in schemas — filodb-defaults.conf:121-275 verbatim semantics.
BUILTIN_SCHEMAS: Dict[str, DataSchema] = {s.name: s for s in [
    _schema("gauge", ["timestamp:ts", "value:double:detectDrops=false"],
            "value",
            ["tTime(0)", "dMin(1)", "dMax(1)", "dSum(1)", "dCount(1)", "dAvg(1)"],
            "time(0)", "ds-gauge"),
    _schema("untyped", ["timestamp:ts", "number:double"], "number"),
    _schema("prom-counter", ["timestamp:ts", "count:double:detectDrops=true"],
            "count", ["tTime(0)", "dLast(1)"], "counter(1)", "prom-counter"),
    _schema("delta-counter",
            ["timestamp:ts", "count:double:{detectDrops=false,delta=true}"],
            "count", ["tTime(0)", "dSum(1)"], "time(0)", "delta-counter"),
    _schema("prom-histogram",
            ["timestamp:ts", "sum:double:detectDrops=true",
             "count:double:detectDrops=true", "h:hist:counter=true"],
            "h", ["tTime(0)", "dLast(1)", "dLast(2)", "hLast(3)"],
            "counter(2)", "prom-histogram"),
    _schema("delta-histogram",
            ["timestamp:ts", "sum:double:{detectDrops=false,delta=true}",
             "count:double:{detectDrops=false,delta=true}",
             "h:hist:{counter=false,delta=true}"],
            "h", ["tTime(0)", "dSum(1)", "dSum(2)", "hSum(3)"],
            "time(0)", "delta-histogram"),
    _schema("otel-cumulative-histogram",
            ["timestamp:ts", "sum:double:detectDrops=true",
             "count:double:detectDrops=true", "h:hist:counter=true",
             "min:double:detectDrops=true", "max:double:detectDrops=true"],
            "h",
            ["tTime(0)", "dLast(1)", "dLast(2)", "hLast(3)", "dMin(4)", "dMax(5)"],
            "counter(2)", "otel-cumulative-histogram"),
    _schema("otel-delta-histogram",
            ["timestamp:ts", "sum:double:{detectDrops=false,delta=true}",
             "count:double:{detectDrops=false,delta=true}",
             "h:hist:{counter=false,delta=true}",
             "min:double:{detectDrops=false,delta=true}",
             "max:double:{detectDrops=false,delta=true}"],
            "h",
            ["tTime(0)", "dSum(1)", "dSum(2)", "hSum(3)", "dMin(4)", "dMax(5)"],
            "time(0)", "otel-delta-histogram"),
    _schema("preagg-gauge",
            ["timestamp:ts", "count:double:detectDrops=false",
             "min:double:detectDrops=false", "sum:double:detectDrops=false",
             "max:double:detectDrops=false"],
            "sum",
            ["tTime(0)", "dSum(1)", "dMin(2)", "dSum(3)", "dMax(4)"],
            "time(0)", "preagg-gauge"),
    _schema("preagg-delta-counter",
            ["timestamp:ts", "count:double:{detectDrops=false,delta=true}",
             "min:double:detectDrops=false",
             "sum:double:{detectDrops=false,delta=true}",
             "max:double:detectDrops=false"],
            "sum",
            ["tTime(0)", "dSum(1)", "dMin(2)", "dSum(3)", "dMax(4)"],
            "time(0)", "preagg-delta-counter"),
    _schema("preagg-delta-histogram",
            ["timestamp:ts", "sum:double:{detectDrops=false,delta=true}",
             "count:double:{detectDrops=false,delta=true}",
             "tscount:double:{detectDrops=false,delta=true}",
             "h:hist:{counter=false,delta=true}"],
            "h",
            ["tTime(0)", "dSum(1)", "dSum(2)", "dSum(3)", "hSum(4)"],
            "time(0)", "preagg-delta-histogram"),
    _schema("preagg-otel-delta-histogram",
            ["timestamp:ts", "sum:double:{detectDrops=false,delta=true}",
             "count:double:{detectDrops=false,delta=true}",
             "tscount:double:{detectDrops=false,delta=true}",
             "h:hist:{counter=false,delta=true}",
             "min:double:{detectDrops=false,delta=true}",
             "max:double:{detectDrops=false,delta=true}"],
            "h",
            ["tTime(0)", "dSum(1)", "dSum(2)", "dSum(3)", "hSum(4)", "dMin(5)",
             "dMax(6)"],
            "time(0)", "preagg-otel-delta-histogram"),
    _schema("ds-gauge",
            ["timestamp:ts", "min:double", "max:double", "sum:double",
             "count:double", "avg:double"],
            "avg"),
]}


@dataclass
class Schemas:
    """Registry of schemas by name and by 16-bit id (Schemas.scala:370)."""
    part: PartitionSchema = field(default_factory=PartitionSchema)
    schemas: Dict[str, DataSchema] = field(
        default_factory=lambda: dict(BUILTIN_SCHEMAS))

    def __post_init__(self):
        self._by_id = {s.schema_id: s for s in self.schemas.values()}
        if len(self._by_id) != len(self.schemas):
            raise ValueError("schema id (hash) conflict — rename a schema")

    def by_name(self, name: str) -> DataSchema:
        return self.schemas[name]

    def by_id(self, schema_id: int) -> DataSchema:
        return self._by_id[schema_id]

    def __contains__(self, name: str) -> bool:
        return name in self.schemas


DEFAULT_SCHEMAS = Schemas()


@dataclass(frozen=True)
class DatasetRef:
    """Dataset identifier (core/DatasetRef)."""
    dataset: str
    database: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.database}.{self.dataset}" if self.database else self.dataset


@dataclass(frozen=True)
class DatasetOptions:
    """Per-dataset options (metadata/Dataset.scala:143)."""
    shard_key_columns: Tuple[str, ...] = ("_ws_", "_ns_", "_metric_")
    metric_column: str = "_metric_"
    max_chunks_size: int = 400
    flush_interval_ms: int = 3_600_000
